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
    ``captured`` (``_build.count``). T1's, T2's, T3's and T4's wrappers
    launch one of three kernels each (T3 four): the newer ones count on their
    ``tma``, ``tf32x3``, ``staged``, ``streamed`` or ``resident`` (T2's and T4's
    staged and streamed kernels in fp32 on ``staged_tf32x3`` and
    ``streamed_tf32x3``: their 3xTF32 products). K1's, the per-block
    kernel's and K2's GEMM's fp32 launches count on their wrappers and again
    by their kernel (``tf32x3``: 3xTF32 on the tensor cores, ``fma``: the
    FMA stages or kernel)."""
    return {"news_encoder_fwd": fused_news_encoder, "news_encoder_bwd": fused_news_encoder_bwd,
            "news_encoder_bwd_block": launch_bwd_core, "news_encoder_bwd_gemm": bwd_gemm,
            "news_encoder_bwd_reduce": reduce_rows, "news_encoder_bwd_mask": emb_mask,
            "tiled_qkv": tiled_qkv, "tiled_attention": tiled_attention, "tiled_pool": tiled_pool,
            "tiled_pool_bwd": tiled_pool_bwd, "tiled_attention_bwd": tiled_attention_bwd,
            "tiled_attention_staged": tiled_attention.staged,
            "tiled_attention_bwd_staged": tiled_attention_bwd.staged,
            "tiled_attention_streamed": tiled_attention.streamed,
            "tiled_attention_bwd_streamed": tiled_attention_bwd.streamed,
            "tiled_attention_staged_tf32x3": tiled_attention.staged_tf32x3,
            "tiled_attention_bwd_staged_tf32x3": tiled_attention_bwd.staged_tf32x3,
            "tiled_attention_streamed_tf32x3": tiled_attention.streamed_tf32x3,
            "tiled_attention_bwd_streamed_tf32x3": tiled_attention_bwd.streamed_tf32x3,
            "tiled_qkv_tma": tiled_qkv.tma, "tiled_pool_resident": tiled_pool.resident,
            "tiled_pool_bwd_resident": tiled_pool_bwd.resident,
            "tiled_pool_streamed": tiled_pool.streamed,
            "tiled_pool_bwd_streamed": tiled_pool_bwd.streamed,
            "tiled_pool_tf32x3": tiled_pool.tf32x3, "tiled_pool_bwd_tf32x3": tiled_pool_bwd.tf32x3,
            "news_encoder_fwd_tf32x3": fused_news_encoder.tf32x3,
            "news_encoder_fwd_fma": fused_news_encoder.fma,
            "news_encoder_bwd_block_tf32x3": launch_bwd_core.tf32x3,
            "news_encoder_bwd_block_fma": launch_bwd_core.fma,
            "news_encoder_bwd_gemm_tf32x3": bwd_gemm.tf32x3,
            "news_encoder_bwd_gemm_fma": bwd_gemm.fma, "tiled_qkv_tf32x3": tiled_qkv.tf32x3,
            "philox_mask_dump": dump_masks, "prng_dropout": dropout_apply}
