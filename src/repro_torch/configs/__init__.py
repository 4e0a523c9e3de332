"""Importing this package registers every model config the port serves."""
from repro_torch.configs import paper_models  # noqa: F401
