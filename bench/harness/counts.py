"""Operations and bytes of a network's work, from its published layer
shapes, and the peaks of the chip they are read against.

A conv site of (R, S, C/groups, K) filters over an H x W x C input to an
H' x W' x K output does R * S * (C / groups) * K * H' * W' multiply-adds,
two operations each; its bytes are the input, the filter and the output,
each once. The counts come from the shapes alone, so they read the same
work whatever algorithm, kernel or fusion carries a site.
"""
from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity), at its
# 700 W limit: fp32 outside the tensor cores, bf16/fp16 on them, HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "float16": 989e12, "mem_bw": 3.35e12},
}

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def site_macs(site):
    return (site["r"] * site["s"] * (site["cin"] // site["groups"])
            * site["cout"] * site["ho"] * site["wo"])


def site_bytes(site, itemsize):
    elems = (site["h"] * site["w"] * site["cin"]
             + site["r"] * site["s"] * (site["cin"] // site["groups"])
             * site["cout"]
             + site["ho"] * site["wo"] * site["cout"])
    return elems * itemsize


def conv_macs(sites):
    """Multiply-adds of the conv sites of one image."""
    return sum(site_macs(s) for s in sites)


def image_flops(sites, head_macs):
    """Operations of one image: 2 x the multiply-adds of every conv site
    and of the classifier."""
    return 2 * (conv_macs(sites) + head_macs)


def conv_roofline_s(sites, dtype, peaks):
    """The least time the chip could spend on one image's conv sites: per
    site the larger of its operations over the dtype's peak and its bytes
    over the memory bandwidth, summed."""
    return sum(max(2 * site_macs(s) / peaks[dtype],
                   site_bytes(s, ITEMSIZE[dtype]) / peaks["mem_bw"])
               for s in sites)
