"""CI-RESNET(n) — the paper's own architecture (Fig. 2c).

RESNET(n): 3x3 stem conv, then 3 ResNet modules of n blocks each (first block
of modules 2,3 subsamples with stride 2), BN+ReLU+skip per block, GAP +
FC(64 -> n_c) + softmax.  Module widths are (16, 32, 64) — the classic
[HZRS15a] profile.  Evidence: the paper's reported max speedup (×2.953 SVHN)
equals MAC(M_{0,1,2})/MAC(M_0) which is ≈2.96 only under this profile, and the
total (253M MACs at n=18) matches ResNet-110's canonical count.  The text's
"32 3x3x3 filters" stem is inconsistent with both; see models/resnet.py.

Cascade: classifier heads branch after modules 0 and 1 with the paper's
classifier enhancement; head 2 is the standard GAP+FC.
"""
from repro_torch.configs.base import CascadeConfig, ModelConfig, register

# n (ResNet blocks per module); the paper's experiments use n=18 (CI-RESNET(18),
# 110 conv layers).  For CPU experiments we also provide n=3 via reduced().
N_BLOCKS = 18

CONFIG = register(ModelConfig(
    name="ci-resnet18",
    family="cnn",
    n_layers=3 * N_BLOCKS,      # resnet blocks across 3 modules
    d_model=64,                 # final feature width (FC input)
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=100,             # n_c (CIFAR-100); overridden per dataset
    norm="layernorm",
    act="gelu",
    dtype="float32",
    cascade=CascadeConfig(
        n_components=3,
        exit_boundaries=(N_BLOCKS, 2 * N_BLOCKS),
        enhance_dim=128,        # the paper's classifier enhancement
        thresholds=(0.9, 0.9, 0.0),
    ),
    source="DOI 10.1007/978-3-030-30484-3_26",
))
