"""Torch ops of the port; the CUDA kernels' wrappers are in ops.kernels.

The names of fwav_tpu.ops, loaded at first use from the module that holds
them (as the package's own names are), so that importing this package
loads no module of it and the kernels' module loads only with an op that
needs it. `voiced_mask` and `build_bank` are the JAX package's
`voiced_mask_jax` and `build_bank_jax`.
"""

import importlib

#: Names loaded at first use, by the module that holds them.
_LAZY = {
    **dict.fromkeys(("affine_match_tiles", "affine_solve_single", "affine_stats",
                     "batched_affine_match", "find_best_domain_affine"), ".affine"),
    **dict.fromkeys(("correlation_upper_bound", "dct2_matrix", "multi_head_embedding",
                     "multi_head_embedding_batch", "quick_energy", "tile_embedding",
                     "tile_embedding_batch", "tonal_embedding", "tonal_embedding_batch",
                     "transient_embedding", "transient_embedding_batch"), ".dct"),
    **dict.fromkeys(("apply_symmetry", "bank_rows_host", "box_sums", "build_bank",
                     "build_domains_host", "build_domains_np", "frame_ranges",
                     "n_domains_for"), ".domains"),
    **dict.fromkeys(("MIPSIndex", "ann_query", "build_ann_index",
                     "build_domain_embeddings"), ".index"),
    **dict.fromkeys(("compute_transient_mask", "get_mel_filterbank", "mel_filterbank",
                     "perceptual_error_batch", "pruned_affine_search"), ".perceptual"),
    **dict.fromkeys(("coarse_refine_search", "exact_search_block", "gain_topk_scan",
                     "refine_from_lobes", "pad_candidates", "range_candidates_from_embedding",
                     "range_candidates_from_embedding_emb", "topk_scores_block",
                     "topk_search_block"), ".search"),
    **dict.fromkeys(("voiced_detection", "voiced_mask"), ".vad"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value


__all__ = sorted(_LAZY)
