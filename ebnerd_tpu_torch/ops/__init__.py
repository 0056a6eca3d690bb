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
    ``captured`` (``_build.count``). T1's wrapper launches one of two
    kernels, T2's, T3's and T4's one of three: the newer ones count on their
    ``tma``, ``staged``, ``streamed`` or ``resident``."""
    return {"news_encoder_fwd": fused_news_encoder, "news_encoder_bwd": fused_news_encoder_bwd,
            "news_encoder_bwd_block": launch_bwd_core, "news_encoder_bwd_gemm": bwd_gemm,
            "news_encoder_bwd_reduce": reduce_rows, "news_encoder_bwd_mask": emb_mask,
            "tiled_qkv": tiled_qkv, "tiled_attention": tiled_attention, "tiled_pool": tiled_pool,
            "tiled_pool_bwd": tiled_pool_bwd, "tiled_attention_bwd": tiled_attention_bwd,
            "tiled_attention_staged": tiled_attention.staged,
            "tiled_attention_bwd_staged": tiled_attention_bwd.staged,
            "tiled_attention_streamed": tiled_attention.streamed,
            "tiled_attention_bwd_streamed": tiled_attention_bwd.streamed,
            "tiled_qkv_tma": tiled_qkv.tma, "tiled_pool_resident": tiled_pool.resident,
            "tiled_pool_bwd_resident": tiled_pool_bwd.resident,
            "tiled_pool_streamed": tiled_pool.streamed,
            "tiled_pool_bwd_streamed": tiled_pool_bwd.streamed,
            "philox_mask_dump": dump_masks, "prng_dropout": dropout_apply}
