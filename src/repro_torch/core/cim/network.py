"""DNN -> crossbar mapping (Section III / Figure 5 of the paper).

A copy of the reference's ``core/cim/network.py``.  Every conv layer is
lowered to a matrix of shape (rows = k*k*Cin, logical_cols = Cout) and tiled
over 128x128 binary arrays: 8 cells per 8-bit weight means an array holds a
128-row x 16-weight tile.  One tile-row — the arrays that share word lines
and therefore input data — is the paper's *block*.

ResNet18 (ImageNet) lowers to 20 conv layers = 5472 arrays in 247 blocks,
the counts quoted in the paper.  ViT-B/16 (``vit_b16_imagenet``, not in the
reference) lowers its patch embedding and each block's four weight products
to 1x1 layers on the 14x14 token grid: 49 layers, 41,760 arrays in 510
blocks; its attention's score and value products have no fixed weights and
stay off the crossbars.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .cost import ArrayConfig, DEFAULT_ARRAY

__all__ = [
    "LayerSpec",
    "NetworkSpec",
    "resnet18_imagenet",
    "vgg11_cifar10",
    "vit",
    "vit_b16_imagenet",
    "with_array",
]


@dataclass(frozen=True)
class LayerSpec:
    """One conv layer lowered to a crossbar matrix."""

    name: str
    kernel: int
    cin: int
    cout: int
    out_hw: int  # output spatial size (H == W)
    stride: int = 1
    array: ArrayConfig = field(default=DEFAULT_ARRAY)

    @property
    def rows(self) -> int:
        return self.kernel * self.kernel * self.cin

    @property
    def n_blocks(self) -> int:
        """Tile-rows: ceil(rows / array rows)."""
        return -(-self.rows // self.array.rows)

    @property
    def arrays_per_block(self) -> int:
        """Tile width: ceil(cout / logical weights per array)."""
        return -(-self.cout // self.array.logical_cols)

    @property
    def n_arrays(self) -> int:
        return self.n_blocks * self.arrays_per_block

    @property
    def patches_per_image(self) -> int:
        return self.out_hw * self.out_hw

    @property
    def macs_per_image(self) -> int:
        return self.patches_per_image * self.rows * self.cout

    def block_row_slices(self) -> list[slice]:
        """Row ranges of the lowered matrix feeding each block."""
        r = self.array.rows
        return [slice(i * r, min((i + 1) * r, self.rows)) for i in range(self.n_blocks)]


@dataclass(frozen=True)
class NetworkSpec:
    name: str
    layers: tuple[LayerSpec, ...]
    family: str = ""  # the forward plan the capture plays; empty: the name
    heads: int = 0  # attention heads a block (a transformer's plan)

    @property
    def plan(self) -> str:
        return self.family or self.name

    @property
    def n_arrays(self) -> int:
        return sum(l.n_arrays for l in self.layers)

    @property
    def n_blocks(self) -> int:
        return sum(l.n_blocks for l in self.layers)

    def min_pes(self, arrays_per_pe: int = 64) -> int:
        return -(-self.n_arrays // arrays_per_pe)

    def block_table(self) -> np.ndarray:
        """(n_blocks, 3) int table: [layer_index, block_index_in_layer, width]."""
        out = []
        for li, layer in enumerate(self.layers):
            for bi in range(layer.n_blocks):
                out.append((li, bi, layer.arrays_per_block))
        return np.asarray(out, dtype=np.int64)


def with_array(spec: NetworkSpec, array: ArrayConfig) -> NetworkSpec:
    """Retarget a network onto a different crossbar geometry / ADC config:
    the lowered matrix shapes are unchanged, the tiling re-derives."""
    return replace(spec, layers=tuple(replace(l, array=array) for l in spec.layers))


def resnet18_imagenet() -> NetworkSpec:
    """The 20 convolutional layers of ResNet18 at 224x224 (the paper's
    workload); the final fc layer is excluded, as in the paper's count."""
    layers: list[LayerSpec] = []

    def conv(name, k, cin, cout, out_hw, stride=1):
        layers.append(LayerSpec(name, k, cin, cout, out_hw, stride))

    conv("conv1", 7, 3, 64, 112, 2)
    for b in range(2):
        conv(f"layer1.{b}.conv1", 3, 64, 64, 56)
        conv(f"layer1.{b}.conv2", 3, 64, 64, 56)
    conv("layer2.0.conv1", 3, 64, 128, 28, 2)
    conv("layer2.0.conv2", 3, 128, 128, 28)
    conv("layer2.0.down", 1, 64, 128, 28, 2)
    conv("layer2.1.conv1", 3, 128, 128, 28)
    conv("layer2.1.conv2", 3, 128, 128, 28)
    conv("layer3.0.conv1", 3, 128, 256, 14, 2)
    conv("layer3.0.conv2", 3, 256, 256, 14)
    conv("layer3.0.down", 1, 128, 256, 14, 2)
    conv("layer3.1.conv1", 3, 256, 256, 14)
    conv("layer3.1.conv2", 3, 256, 256, 14)
    conv("layer4.0.conv1", 3, 256, 512, 7, 2)
    conv("layer4.0.conv2", 3, 512, 512, 7)
    conv("layer4.0.down", 1, 256, 512, 7, 2)
    conv("layer4.1.conv1", 3, 512, 512, 7)
    conv("layer4.1.conv2", 3, 512, 512, 7)
    return NetworkSpec("resnet18", tuple(layers))


def vgg11_cifar10() -> NetworkSpec:
    """The 8 convolutional layers of VGG11 at 32x32 (the paper's second
    workload)."""
    cfg = [
        # (cin, cout, out_hw) — maxpool after convs 1, 2, 4, 6, 8
        (3, 64, 32),
        (64, 128, 16),
        (128, 256, 8),
        (256, 256, 8),
        (256, 512, 4),
        (512, 512, 4),
        (512, 512, 2),
        (512, 512, 2),
    ]
    layers = tuple(
        LayerSpec(f"conv{i+1}", 3, cin, cout, hw) for i, (cin, cout, hw) in enumerate(cfg)
    )
    return NetworkSpec("vgg11", layers)


def vit(name: str, depth: int, width: int, mlp: int, heads: int, patch: int, image_hw: int) -> NetworkSpec:
    """A plain ViT's crossbar layers: the patch embedding (a ``patch`` x
    ``patch`` conv of stride ``patch``), then per block ``qkv``, ``proj``,
    ``fc1`` and ``fc2`` as 1x1 layers on the token grid.  The class token,
    the final norm and the head are left out (a global-average-pooled head,
    as ``resnet18`` and ``vgg11`` leave out their fc layer)."""
    grid = image_hw // patch
    layers = [LayerSpec("patch", patch, 3, width, grid, patch)]
    for b in range(depth):
        layers += [LayerSpec(f"{b}.qkv", 1, width, 3 * width, grid), LayerSpec(f"{b}.proj", 1, width, width, grid),
                   LayerSpec(f"{b}.fc1", 1, width, mlp, grid), LayerSpec(f"{b}.fc2", 1, mlp, width, grid)]
    return NetworkSpec(name, tuple(layers), family="vit", heads=heads)


def vit_b16_imagenet() -> NetworkSpec:
    """ViT-B/16 at 224x224 (Dosovitskiy et al., arXiv:2010.11929, Table 1):
    12 blocks, width 768, MLP 3072, 12 heads, 196 tokens."""
    return vit("vit_b16", depth=12, width=768, mlp=3072, heads=12, patch=16, image_hw=224)
