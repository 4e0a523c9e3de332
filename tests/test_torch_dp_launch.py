"""``repro_torch.launch.train`` over 2 gloo ranks on the CPU (the
``REPRO_*`` variables, as a launcher of several processes sets them)
against one process with the same seed, batch and steps: the same
losses within 1e-5 relative.  Every rank draws the whole batch and
takes its rows of the tokens and of the stub inputs; reduced mixtral
dispatches its experts over the global batch, reduced whisper's encoder
reads each rank's rows of the stub frames.  The ranks run
``tests/_torch_dist_worker.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.dist_smoke import run_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")


@pytest.mark.parametrize("arch,steps,seq", [("mixtral-8x22b", 3, 16),
                                            ("whisper-large-v3", 2, 8)])
def test_launch_train_two_ranks_match_one(tmp_path, arch, steps, seq):
    from repro_torch.launch.train import run
    args = dict(arch=arch, use_reduced=True, steps=steps, batch=4, seq=seq,
                lr=1e-3, log_every=0, device="cpu")
    out = run_ranks([WORKER, "train", str(tmp_path), json.dumps(args)], 2,
                    timeout=120, coordinator=f"file://{tmp_path}/store")
    for rank, (rc, text) in enumerate(out):
        assert rc == 0, f"rank {rank} exit {rc}:\n{text[-3000:]}"
    one = run(**args)
    for r in (0, 1):
        np.testing.assert_allclose(np.load(tmp_path / f"losses{r}.npy"), one,
                                   rtol=1e-5)
