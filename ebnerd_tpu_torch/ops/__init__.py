"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Kernels are built at first launch, never at import."""
from .dropout import dropout_apply, dropout_reference, prng_dropout
from .news_encoder import (bwd_gemm, emb_mask, fused_news_encoder, fused_news_encoder_bwd,
                           launch_bwd_core, news_encoder_reference, reduce_rows, tiled_attention,
                           tiled_attention_bwd, tiled_pool, tiled_pool_bwd, tiled_qkv)
from .philox import dump_masks

__all__ = ["fused_news_encoder", "news_encoder_reference", "prng_dropout", "dropout_reference",
           "kernel_counters"]


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by its kernel's name; each counts its
    launches in ``launches`` and those recorded into a CUDA graph in
    ``captured`` (``_build.count``). T2's and T4's wrappers launch one of
    two kernels: the staged ones count on their ``staged``."""
    return {"news_encoder_fwd": fused_news_encoder, "news_encoder_bwd": fused_news_encoder_bwd,
            "news_encoder_bwd_block": launch_bwd_core, "news_encoder_bwd_gemm": bwd_gemm,
            "news_encoder_bwd_reduce": reduce_rows, "news_encoder_bwd_mask": emb_mask,
            "tiled_qkv": tiled_qkv, "tiled_attention": tiled_attention, "tiled_pool": tiled_pool,
            "tiled_pool_bwd": tiled_pool_bwd, "tiled_attention_bwd": tiled_attention_bwd,
            "tiled_attention_staged": tiled_attention.staged,
            "tiled_attention_bwd_staged": tiled_attention_bwd.staged,
            "philox_mask_dump": dump_masks, "prng_dropout": dropout_apply}
