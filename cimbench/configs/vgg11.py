"""Plain reference of ``vgg11.json``: VGG11's 8 conv layers at 32x32
(Simonyan and Zisserman, arXiv:1409.1556) as the quantized calibration
forward plays them, in NumPy (``cimbench.reference.capture``), with a 2x2
max pool after convs 1, 2, 4, 6 and 8."""

from cimbench.reference.capture import bn_relu, max_pool

POOL_AFTER = {0, 1, 3, 5, 7}


def forward(p, x):
    for i in range(len(p.layers)):
        x = bn_relu(p.conv(i, x))
        if i in POOL_AFTER:
            x = max_pool(x, 2, 2)
    return x
