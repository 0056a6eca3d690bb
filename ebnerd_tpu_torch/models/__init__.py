"""Model families of the port (NRMS so far)."""
from .config import HParamsBase, HParamsNRMS
from .inputs import token_batch
from .newsrec import NRMS

__all__ = ["HParamsBase", "HParamsNRMS", "NRMS", "token_batch"]
