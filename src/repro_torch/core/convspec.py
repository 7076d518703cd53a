"""ConvSpec and FusedBlockSpec: the keys the autotuner dispatches on.

The port's copy of ``repro/core/convspec.py``, field for field, so specs
compare equal across the two packages and plan JSON moves between them.
``dtype`` is part of the key: byte terms scale with ``element_size``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dtypes import canonical, element_size


@dataclass(frozen=True)
class ConvSpec:
    h: int
    w: int
    c: int
    k: int
    r: int = 3
    s: int = 3
    stride: int = 1
    batch: int = 1
    dtype: str = "float32"
    groups: int = 1  # feature groups; groups == c == k is depthwise

    def __post_init__(self):
        if self.c % self.groups or self.k % self.groups:
            raise ValueError(f"channels not divisible by groups: {self}")

    @property
    def c_per_group(self) -> int:
        """Input channels each output channel convolves (filter depth)."""
        return self.c // self.groups

    @property
    def depthwise(self) -> bool:
        """groups == c and k = M·c for an integer channel multiplier M."""
        return self.groups > 1 and self.groups == self.c \
            and self.k % self.c == 0

    @property
    def channel_multiplier(self) -> int:
        if not self.depthwise:
            raise ValueError(f"not a depthwise spec: {self}")
        return self.k // self.c

    @property
    def out_h(self):
        return -(-self.h // self.stride)  # SAME: ceil(h / stride)

    @property
    def out_w(self):
        return -(-self.w // self.stride)

    @property
    def flops(self) -> int:
        """Useful MACs x2 (SAME padding)."""
        return 2 * self.batch * self.out_h * self.out_w * self.r * self.s \
            * self.c_per_group * self.k

    @property
    def element_size(self) -> int:
        return element_size(self.dtype)

    @property
    def bytes_min(self) -> int:
        """Compulsory traffic: image in + filters in + output out."""
        el = self.element_size
        return el * (self.batch * self.h * self.w * self.c
                     + self.r * self.s * self.c_per_group * self.k
                     + self.batch * self.out_h * self.out_w * self.k)

    @property
    def epilogue_bytes(self) -> int:
        """Traffic of an unfused scale/bias/act pass: read + write of the
        conv output."""
        return 2 * self.element_size * self.batch * self.out_h \
            * self.out_w * self.k

    @classmethod
    def from_tensors(cls, x, w, stride):
        """The spec of real tensors: NHWC image, HWIO filters."""
        b, h, ww, c = x.shape
        r, s, c_per_group, k = w.shape
        if c % c_per_group:
            raise ValueError(
                f"image channels {c} not divisible by filter depth "
                f"{c_per_group}")
        return cls(h=h, w=ww, c=c, k=k, r=r, s=s, stride=stride, batch=b,
                   dtype=canonical(x.dtype), groups=c // c_per_group)


@dataclass(frozen=True)
class FusedBlockSpec:
    """The key for a block-level fused kernel candidate.

    ``inverted_residual``: MobileNet's expand -> depthwise -> project
    chain. ``residual_conv``: a ResNet block's last (stride-1) conv with
    the shortcut add and outer ReLU folded into its output write.
    ``h``/``w`` are the input spatial dims of the fused region.
    """
    kind: str
    h: int
    w: int
    cin: int
    mid: int
    cout: int
    r: int = 3
    s: int = 3
    stride: int = 1
    residual: bool = False
    batch: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.kind not in ("inverted_residual", "residual_conv"):
            raise ValueError(f"unknown block kind {self.kind!r}")
        if self.kind == "residual_conv" and not (
                self.stride == 1 and self.residual and self.cin == self.mid):
            raise ValueError(f"bad residual_conv block: {self}")
        if self.residual and self.kind == "inverted_residual" and not (
                self.stride == 1 and self.cin == self.cout):
            raise ValueError(f"bad residual inverted block: {self}")

    @property
    def expanded(self) -> bool:
        """Whether the block has a distinct expansion conv (t > 1)."""
        return self.kind == "inverted_residual" and self.mid != self.cin

    @property
    def out_h(self) -> int:
        return -(-self.h // self.stride)

    @property
    def out_w(self) -> int:
        return -(-self.w // self.stride)

    @property
    def element_size(self) -> int:
        return element_size(self.dtype)

    def conv_specs(self) -> tuple:
        """((name, ConvSpec), ...): the per-layer convs this block
        replaces, named like the model's conv-site suffixes."""
        if self.kind == "residual_conv":
            suffix = "c2" if (self.r, self.s) != (1, 1) else "c3"
            return ((suffix, ConvSpec(
                h=self.h, w=self.w, c=self.mid, k=self.cout, r=self.r,
                s=self.s, batch=self.batch, dtype=self.dtype)),)
        parts = []
        if self.expanded:
            parts.append(("pw1", ConvSpec(
                h=self.h, w=self.w, c=self.cin, k=self.mid, r=1, s=1,
                batch=self.batch, dtype=self.dtype)))
        parts.append(("dw", ConvSpec(
            h=self.h, w=self.w, c=self.mid, k=self.mid, r=self.r, s=self.s,
            stride=self.stride, groups=self.mid, batch=self.batch,
            dtype=self.dtype)))
        parts.append(("pw2", ConvSpec(
            h=self.out_h, w=self.out_w, c=self.mid, k=self.cout, r=1, s=1,
            batch=self.batch, dtype=self.dtype)))
        return tuple(parts)

    @property
    def saved_bytes(self) -> int:
        """Device-memory round trips the fusion removes."""
        el = self.element_size
        if self.kind == "residual_conv":
            return 2 * el * self.batch * self.out_h * self.out_w * self.cout
        hp = (self.out_h - 1) * self.stride + self.r
        wp = (self.out_w - 1) * self.stride + self.s
        saved = 0
        if self.expanded:
            saved += el * self.batch * self.mid * (self.h * self.w + hp * wp)
        saved += 2 * el * self.batch * self.out_h * self.out_w * self.mid
        return saved

    @property
    def residual_pass_bytes(self) -> int:
        """Traffic of the unfused shortcut-add pass (read conv output,
        read identity, write sum)."""
        if not self.residual:
            return 0
        return 3 * self.element_size * self.batch * self.out_h \
            * self.out_w * self.cout
