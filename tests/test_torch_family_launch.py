"""The port's launcher serves every config of the registry at reduced
size on the CPU (``python -m repro_torch.launch.serve --arch <name>
--reduced --device cpu``): every request finishes with its tokens, the
stub inputs are drawn for the vision and audio models, and the
ping-pong runtime is refused where the JAX runtime refuses it."""
import pytest
import torch

from repro_torch.config import get_config, list_configs, reduced
from repro_torch.launch.serve import run
from repro_torch.models.stubs import extra_inputs

torch.set_num_threads(1)

PAPER = ("mixtral-8x22b", "dbrx", "scaled-moe")
NEW = [n for n in list_configs() if n not in PAPER]


@pytest.mark.parametrize("arch", NEW)
def test_launcher_serves_every_new_config(arch, capsys):
    st = run(arch=arch, use_reduced=True, device="cpu", n_requests=3, max_new=3,
             max_batch=2, max_seq=32, prompt_len=5, verbose=True)
    assert st["finished"] == 3 and st["tokens"] == 9
    assert st["kernel_launches"]["decode_attention"] == 0    # plain on the CPU
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "served 3 requests" in out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b",
                                  "whisper-large-v3", "llama-3.2-vision-90b"])
def test_launcher_refuses_pingpong_on_the_new_kinds(arch):
    with pytest.raises(NotImplementedError, match="layer kind"):
        run(arch=arch, use_reduced=True, device="cpu", runtime="pingpong",
            microbatches=2, n_requests=1, verbose=False)


def test_stub_inputs_by_family():
    """Patches for the vision model, frames for the audio model, nothing
    for the text models; the same draw each call (fixed seeds)."""
    for name in list_configs():
        cfg = reduced(get_config(name))
        ex = extra_inputs(cfg, 2, device="cpu")
        keys = set()
        if cfg.arch_type == "vlm":
            keys.add("cross_embeds")
            assert ex["cross_embeds"].shape == (2, cfg.cross_source_len, cfg.d_model)
        if cfg.encoder is not None:
            keys.add("frames")
            assert ex["frames"].shape == (2, cfg.encoder.source_len, cfg.d_model)
        assert set(ex) == keys
        again = extra_inputs(cfg, 2, device="cpu")
        assert all(torch.equal(ex[k], again[k]) for k in ex)
