"""Plain reference of ``resnet18.json``: ResNet18's 20 conv layers at
224x224 (He et al., arXiv:1512.03385) as the quantized calibration forward
plays them, in NumPy (``cimbench.reference.capture``).  No fc layer."""

from cimbench.reference.capture import bn_relu, max_pool_same

import numpy as np


def forward(p, x):
    x = bn_relu(p.conv(0, x))  # conv1, 224 -> 112
    x = max_pool_same(x, 3, 2)  # 112 -> 56, pads (0, 1) with -inf

    def basic(x, i, down=None):
        h = bn_relu(p.conv(i, x))
        h = p.conv(i + 1, h)
        sc = p.conv(down, x) if down is not None else x
        return np.maximum(bn_relu(h) + sc, np.float32(0.0))

    x = basic(x, 1)
    x = basic(x, 3)
    x = basic(x, 5, down=7)
    x = basic(x, 8)
    x = basic(x, 10, down=12)
    x = basic(x, 13)
    x = basic(x, 15, down=17)
    x = basic(x, 18)
    return x
