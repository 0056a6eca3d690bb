"""Model families of the port (NRMS, LSTUR, NAML so far)."""
from .config import HParamsBase, HParamsLSTUR, HParamsNAML, HParamsNRMS
from .inputs import builder_for, naml_batch, token_batch
from .newsrec import LSTUR, NAML, NRMS

__all__ = ["HParamsBase", "HParamsNRMS", "HParamsLSTUR", "HParamsNAML", "NRMS", "LSTUR", "NAML",
           "token_batch", "naml_batch", "builder_for"]
