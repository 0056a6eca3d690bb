"""Model families of the port (NRMS so far)."""
from .config import HParamsBase, HParamsNRMS
from .newsrec import NRMS

__all__ = ["HParamsBase", "HParamsNRMS", "NRMS"]
