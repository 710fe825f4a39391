from healnet_tpu_torch.models.baselines.common import (
    AlphaDropout,
    AttnNetGated,
    BilinearFusion,
    SNNBlock,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from healnet_tpu_torch.models.baselines.generic import FCNN, RegularizedFCNN
from healnet_tpu_torch.models.baselines.mcat import MCAT, MILAttentionNet, SNN
from healnet_tpu_torch.models.baselines.mm_prognosis import Highway, MMPrognosis
from healnet_tpu_torch.models.baselines.motcat import MOTCAT, OTAttention, sinkhorn_log
from healnet_tpu_torch.models.baselines.multimodn import (
    ClassDecoder,
    LogisticDecoder,
    MLPDecoder,
    MLPEncoder,
    MultiModNHistory,
    MultiModNModule,
    PatchEncoder,
    ResNetEncoder,
)

__all__ = [
    "AlphaDropout",
    "AttnNetGated",
    "BilinearFusion",
    "SNNBlock",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "FCNN",
    "RegularizedFCNN",
    "MCAT",
    "MILAttentionNet",
    "SNN",
    "Highway",
    "MMPrognosis",
    "MOTCAT",
    "OTAttention",
    "sinkhorn_log",
    "ClassDecoder",
    "LogisticDecoder",
    "MLPDecoder",
    "MLPEncoder",
    "MultiModNHistory",
    "MultiModNModule",
    "PatchEncoder",
    "ResNetEncoder",
]
