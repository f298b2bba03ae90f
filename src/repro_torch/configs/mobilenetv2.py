"""MobileNetV2 — the paper's own evaluation model [Sandler et al., CVPR 2018].

Used for the faithful AMP4EC reproduction (Table I/II, partition sizes).
Defined by its torchvision-equivalent inverted-residual schedule; flattens to
141 leaf layers (52 Conv2d + 52 BatchNorm + 35 ReLU6 + Dropout + Linear).
"""

# (expansion t, out channels c, repeats n, stride s) — Table 2 of the paper.
INVERTED_RESIDUAL_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
INPUT_CHANNELS = 32
LAST_CHANNELS = 1280
NUM_CLASSES = 1000
IMAGE_SIZE = 224
