"""Gradient codecs ported so far (the rest of the catalog is queued in
ROADMAP)."""

from grace_tpu_torch.compressors.countsketch import CountSketchCompressor
from grace_tpu_torch.compressors.fp16 import FP16Compressor
from grace_tpu_torch.compressors.homoqsgd import HomoQSGDCompressor
from grace_tpu_torch.compressors.none import NoneCompressor
from grace_tpu_torch.compressors.qsgd import QSGDCompressor
from grace_tpu_torch.compressors.signsgd import (SignSGDCompressor,
                                                 SignumCompressor)
from grace_tpu_torch.compressors.topk import TopKCompressor, static_k

__all__ = ["CountSketchCompressor", "FP16Compressor", "HomoQSGDCompressor", "NoneCompressor",
           "QSGDCompressor", "SignSGDCompressor", "SignumCompressor",
           "TopKCompressor", "static_k"]
