"""Model families of the port: NRMS (with its dense stack), NRMSDocVec,
LSTUR, NPA, NAML, Fastformer and FastformerWu."""
from .config import (HParamsBase, HParamsFastformer, HParamsLSTUR, HParamsNAML, HParamsNPA,
                     HParamsNRMS, HParamsNRMSDocVec)
from .fastformer import Fastformer, FastformerWu
from .inputs import builder_for, device_tables, docvec_batch, naml_batch, token_batch
from .newsrec import LSTUR, NAML, NPA, NRMS, NRMSDocVec

__all__ = ["HParamsBase", "HParamsNRMS", "HParamsNRMSDocVec", "HParamsLSTUR", "HParamsNPA",
           "HParamsNAML", "HParamsFastformer", "NRMS", "NRMSDocVec", "LSTUR", "NPA", "NAML",
           "Fastformer", "FastformerWu", "token_batch", "docvec_batch", "naml_batch",
           "builder_for", "device_tables"]
