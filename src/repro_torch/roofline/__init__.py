"""The three-term roofline (``roofline.analysis``) and the operation
counts of a step run on fake tensors (``roofline.op_count``), the port's
counterpart of the reference's HLO parse."""
from repro_torch.roofline.analysis import (
    HW_H100,
    HW_V5E,
    RooflineTerms,
    mfu_fraction,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.op_count import analyze

__all__ = ["HW_H100", "HW_V5E", "RooflineTerms", "analyze", "mfu_fraction", "model_flops",
           "roofline_terms"]
