"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Kernels are built at first launch, never at import."""
from .news_encoder import fused_news_encoder, news_encoder_reference

__all__ = ["fused_news_encoder", "news_encoder_reference"]
