"""The gradient codecs: the JAX package's whole catalog."""

from grace_tpu_torch.compressors.adaq import AdaqCompressor
from grace_tpu_torch.compressors.countsketch import CountSketchCompressor
from grace_tpu_torch.compressors.cyclictopk import CyclicTopKCompressor
from grace_tpu_torch.compressors.dgc import DgcCompressor
from grace_tpu_torch.compressors.efsignsgd import EFSignSGDCompressor
from grace_tpu_torch.compressors.fp16 import FP16Compressor
from grace_tpu_torch.compressors.homoqsgd import HomoQSGDCompressor
from grace_tpu_torch.compressors.inceptionn import InceptionNCompressor
from grace_tpu_torch.compressors.natural import NaturalCompressor
from grace_tpu_torch.compressors.none import NoneCompressor
from grace_tpu_torch.compressors.onebit import OneBitCompressor
from grace_tpu_torch.compressors.powersgd import PowerSGDCompressor
from grace_tpu_torch.compressors.qsgd import QSGDCompressor
from grace_tpu_torch.compressors.randomk import RandomKCompressor
from grace_tpu_torch.compressors.signsgd import (SignSGDCompressor,
                                                 SignumCompressor)
from grace_tpu_torch.compressors.sketch import SketchCompressor
from grace_tpu_torch.compressors.terngrad import TernGradCompressor
from grace_tpu_torch.compressors.threshold import ThresholdCompressor
from grace_tpu_torch.compressors.topk import TopKCompressor, static_k
from grace_tpu_torch.compressors.u8bit import U8bitCompressor

__all__ = ["AdaqCompressor", "CountSketchCompressor", "CyclicTopKCompressor",
           "DgcCompressor", "EFSignSGDCompressor", "FP16Compressor",
           "HomoQSGDCompressor", "InceptionNCompressor", "NaturalCompressor",
           "NoneCompressor", "OneBitCompressor", "PowerSGDCompressor",
           "QSGDCompressor", "RandomKCompressor", "SignSGDCompressor",
           "SignumCompressor", "SketchCompressor", "TernGradCompressor",
           "ThresholdCompressor", "TopKCompressor", "U8bitCompressor",
           "static_k"]
