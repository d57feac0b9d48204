"""Ops: plain torch functions and the wrappers of the hand-written CUDA kernels."""


def kernel_counters() -> dict:
    """Each kernel's wrapper, which counts its launches (`fn.launches`)."""
    from golfaction_tpu_torch.ops import (gcn_tail, group_norm, heatmap, preprocess, requant,
                                          softdtw)

    return {"preprocess": preprocess.crop_resize_normalize, "gcn_tail": gcn_tail.gcn_block_tail,
            "softdtw": softdtw.wavefront, "decode": heatmap.decode_heatmaps,
            "softdtw_bwd": softdtw.softdtw_backward, "requant": requant.requant_epilogue,
            "preprocess_bf16": preprocess.crop_resize_normalize_bf16,
            "group_norm": group_norm.group_norm_act}
