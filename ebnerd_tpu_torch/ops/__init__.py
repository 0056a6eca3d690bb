"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Kernels are built at first launch, never at import."""
from .dropout import dropout_reference, prng_dropout
from .news_encoder import fused_news_encoder, news_encoder_reference

__all__ = ["fused_news_encoder", "news_encoder_reference", "prng_dropout", "dropout_reference"]
