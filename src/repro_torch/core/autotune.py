"""Auto-tuning (``repro/core/autotune.py``): the cost model and the
measured tuner.

A roofline model over each candidate's device-memory traffic, operations
and on-chip working set picks one algorithm and its parameters per conv
site; ``build_plan`` turns a network's sites into a ``TuningPlan``, whose
JSON (schema v2, v1 readable) is byte-for-byte the reference's, so plans
move between the two packages.

The device the model describes is one explicit argument, ``device``.
Its default, ``REFERENCE_DEVICE``, copies the three constants of
``repro/core/autotune.py:33-35`` so that the port picks the plans the
reference picks; it is not a model of any card the port runs on.

Measured mode (``measured_select``) times every feasible candidate where
it runs, ``measure_on``: the card unless the caller asks for the CPU. On
the card each timing is one replay of a CUDA graph of the candidate's
call, timed with CUDA events, as a deployment that replays graphs pays
it; on the CPU it is the host clock over the plain versions, which
proves nothing about a kernel. ``select`` memoises per site, keyed by
the measurement settings too; block fusion stays cost-model in both
modes, as in the reference.
"""
from __future__ import annotations

import functools
import json
import logging
import time
from dataclasses import asdict, dataclass, field

import torch

from repro_torch.core.convspec import ConvSpec, FusedBlockSpec
from repro_torch.core.device import capture, resolve_device
from repro_torch.core.dtypes import ACC_BYTES, torch_dtype

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class DeviceModel:
    """What the cost model knows of a device."""
    peak_flops: float  # operations per second
    mem_bw: float  # device-memory bytes per second
    onchip_bytes: int  # the working set a kernel may hold on chip


# The reference package's constants (repro/core/autotune.py:33-35).
REFERENCE_DEVICE = DeviceModel(peak_flops=197e12, mem_bw=819e9,
                               onchip_bytes=16 * 2 ** 20)

MODES = ("cost_model", "measured")


@dataclass(frozen=True)
class Choice:
    algorithm: str
    params: tuple  # ((name, value), ...)
    est_time: float
    est_bytes: int
    est_flops: int
    vmem: int  # on-chip working set; named as in the reference's JSON

    def to_dict(self) -> dict:
        d = asdict(self)
        d["params"] = [list(p) for p in self.params]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Choice":
        d = dict(d)
        d["params"] = tuple((str(k), int(v)) for k, v in d["params"])
        return cls(**d)


def tunable(spec: ConvSpec) -> bool:
    """Whether a kernel family applies: dense spatial convs at stride 1
    or 2, depthwise convs at stride 1 or 2, dense 1x1 convs at stride 1
    or 2. Everything else takes the escape hatch."""
    if spec.depthwise:
        return spec.stride in (1, 2)
    if spec.groups != 1:
        return False
    if spec.r == 1 and spec.s == 1:
        return spec.stride in (1, 2)
    return spec.stride in (1, 2) and spec.r > 1 and spec.s > 1


def xla_choice(spec: ConvSpec, *, device=REFERENCE_DEVICE,
               epilogue=False) -> Choice:
    """Roofline estimate of the escape hatch, which pays an extra output
    round trip for an unfused epilogue."""
    bts = spec.bytes_min + (spec.epilogue_bytes if epilogue else 0)
    t = max(spec.flops / device.peak_flops, bts / device.mem_bw)
    return Choice("xla", (), t, bts, spec.flops, 0)


def _candidates(spec: ConvSpec, epilogue=False):
    """(algorithm, params, bytes, flops, on-chip working set) per
    candidate, enumerated as the reference does."""
    el = spec.element_size
    B, H, W, C, K, R, S = (spec.batch, spec.out_h, spec.out_w, spec.c,
                           spec.k, spec.r, spec.s)
    stride = spec.stride
    out = B * H * W * K * el
    ep = 2 * K * el if epilogue else 0  # fused scale+bias vector loads
    P = H * W
    cands = []

    if spec.depthwise:
        m = spec.channel_multiplier
        hp = (H - 1) * stride + R
        wp = (W - 1) * stride + S
        img = B * hp * wp * C * el
        filt = R * S * K * el
        for tc in (128, 256, 512):
            tc = min(tc, K)
            vmem = hp * wp * -(-tc // m) * el + R * S * tc * el \
                + P * tc * ACC_BYTES
            cands.append(("depthwise", (("block_c", tc),),
                          img + filt + out + ep, spec.flops, vmem))
            if tc == K:
                break
        return cands

    if R == 1 and S == 1:
        img = B * spec.h * spec.w * C * el  # full image even when strided
        filt = C * K * el
        for tk in (128, 256, 512):
            tk = min(tk, K)
            vmem = (img // max(B, 1)) + C * tk * el + P * tk * ACC_BYTES
            cands.append(("pointwise", (("block_k", tk),),
                          img + filt + out + ep, spec.flops, vmem))
            if tk == K:
                break
        return cands

    hp = (H - 1) * stride + R
    wp = (W - 1) * stride + S
    img = B * hp * wp * C * el
    filt = R * S * C * K * el

    for tk in (128, 256, 512):
        tk = min(tk, K)
        vmem = (img // max(B, 1)) + R * S * C * tk * el + P * tk * ACC_BYTES
        cands.append(("ilpm", (("block_k", tk),), img + filt + out + ep,
                      spec.flops, vmem))
        if tk == K:
            break

    for th in (4, 8, 16):
        th = min(th, H)
        bh = (th - 1) * stride + R
        band = B * -(-H // th) * bh * wp * C * el
        vmem = bh * wp * C * el + filt + th * W * K * ACC_BYTES
        cands.append(("direct", (("block_h", th),), band + filt + out + ep,
                      spec.flops, vmem))
        if th == H:
            break

    if stride != 1:
        return cands

    patches = B * P * R * S * C * el
    ep_im2col = spec.epilogue_bytes if epilogue else 0
    vmem = min(P, 256) * R * S * C * el + R * S * C * 128 * el \
        + 256 * 128 * ACC_BYTES
    cands.append(("im2col", (),
                  img + patches + patches + filt + out + ep_im2col,
                  spec.flops, vmem))

    for tk in (128, 256):
        tk = min(tk, K)
        vmem = (img // max(B, 1)) + P * R * S * C * el // max(
            -(-K // tk), 1) + R * S * C * tk * el + P * tk * ACC_BYTES
        cands.append(("libdnn", (("block_k", tk),), img + filt + out + ep,
                      int(spec.flops * 1.10), vmem))
        if tk == K:
            break

    if (R, S) == (3, 3) and H % 2 == 0 and W % 2 == 0:
        v_bytes = B * 16 * (H // 2) * (W // 2) * C * el
        m_bytes = B * 16 * (H // 2) * (W // 2) * K * el
        traffic = img + v_bytes + v_bytes + 16 * C * K * el + m_bytes \
            + m_bytes + out + ep
        flops = 2 * B * 16 * (H // 2) * (W // 2) * C * K  # the 16 GEMMs
        vmem = (img // max(B, 1)) + 16 * C * K * el \
            + min((H // 2) * (W // 2), 512) * (C + K) * el
        cands.append(("winograd", (), traffic, flops, vmem))
    return cands


def cost_model_select(spec: ConvSpec, *, device=REFERENCE_DEVICE,
                      epilogue=False) -> Choice:
    """The feasible candidate with the least roofline time."""
    if not tunable(spec):
        return xla_choice(spec, device=device, epilogue=epilogue)
    best = None
    for algo, params, bts, flops, vmem in _candidates(spec, epilogue):
        if vmem > device.onchip_bytes:
            continue
        t = max(flops / device.peak_flops, bts / device.mem_bw)
        if best is None or t < best.est_time:
            best = Choice(algo, params, t, bts, flops, vmem)
    if best is None:
        raise ValueError(f"no feasible algorithm for {spec}")
    return best


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown tuning mode {mode!r}; want one of {MODES}")


def _synth_inputs(spec: ConvSpec, device):
    """A random pre-padded input and filter of the spec on ``device``,
    from ``torch.Generator``s seeded 0 and 1: the padded size follows the
    stride ((out - 1) * stride + r), the filter depth the groups."""
    dtype = torch_dtype(spec.dtype)
    hp = (spec.out_h - 1) * spec.stride + spec.r
    wp = (spec.out_w - 1) * spec.stride + spec.s
    x = torch.randn((spec.batch, hp, wp, spec.c), dtype=dtype, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    w = torch.randn((spec.r, spec.s, spec.c_per_group, spec.k), dtype=dtype,
                    device=device,
                    generator=torch.Generator(device).manual_seed(1))
    return x, w


def host_times(call, repeats, algorithm=None, params=None):
    """Host-clock seconds of ``repeats`` calls after a warm-up call: the
    CPU's timer, over the plain versions."""
    call()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        out.append(time.perf_counter() - t0)
    return out


def replay_times(call, repeats, algorithm=None, params=None):
    """CUDA-event seconds of ``repeats`` replays of a graph of one
    ``call``, after a warm-up call on a side stream and a warm-up replay:
    the card's timer, what a deployment that replays graphs pays, without
    the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph, stream=side):
        call()
    graph.replay()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / 1e3)
    return out


def measured_select(spec: ConvSpec, x=None, w=None, *, repeats=3,
                    noise_floor=0.5, epilogue=False, measure_on=None,
                    timer=None, device=REFERENCE_DEVICE) -> Choice:
    """Wall-clock tuning, the paper's procedure.

    ``x`` is the pre-padded input (with ``w``, synthesised when omitted);
    the candidates run where ``measure_on`` says, else where ``x`` lies,
    else on the card, and without a card and without either this raises.
    Each feasible candidate runs once to warm up, then ``repeats`` times,
    and scores its minimum. ``timer(call, repeats, algorithm, params)``
    returns the seconds of each repeat: by default ``replay_times`` on the
    card and ``host_times`` on the CPU. A candidate that fails is logged
    and skipped. The cost model's pick stays unless the measured winner
    is more than ``noise_floor`` (a fraction) faster; use
    ``noise_floor=0`` on the card for pure wall-clock selection.
    Non-tunable specs take the ``xla`` Choice untimed."""
    from repro_torch.kernels import ops

    if not tunable(spec):
        return xla_choice(spec, device=device, epilogue=epilogue)
    on = resolve_device(measure_on if measure_on is not None
                        else x.device if x is not None else None)
    if x is None or w is None:
        x, w = _synth_inputs(spec, on)
    if timer is None:
        timer = replay_times if on.type == "cuda" else host_times

    best = None
    timed: dict[tuple, float] = {}
    for algo, params, bts, flops, vmem in _candidates(spec, epilogue):
        if vmem > device.onchip_bytes:
            continue
        call = functools.partial(ops.dispatch, algo, x, w,
                                 stride=spec.stride, **dict(params))
        try:
            with torch.inference_mode():
                t = min(timer(call, repeats, algo, params))
        except Exception as e:
            log.warning("measured_select: candidate %s%r failed on %s: %s",
                        algo, dict(params), spec, e)
            continue
        timed[(algo, params)] = t
        if best is None or t < best.est_time:
            best = Choice(algo, params, t, bts, flops, vmem)
    if best is None:
        raise RuntimeError(f"every candidate failed for {spec}")

    model = cost_model_select(spec, device=device, epilogue=epilogue)
    t_model = timed.get((model.algorithm, model.params))
    if t_model is not None and t_model <= best.est_time * (1 + noise_floor):
        return Choice(model.algorithm, model.params, t_model,
                      model.est_bytes, model.est_flops, model.vmem)
    return best


_CACHE: dict[tuple, Choice] = {}


def select(spec: ConvSpec, mode: str = "cost_model", *, repeats=3,
           noise_floor=0.5, epilogue=False, device=REFERENCE_DEVICE,
           measure_on=None) -> Choice:
    """Memoised per-site selection: tune once, reuse per network. The
    key carries ``epilogue`` and the device model, and in measured mode
    ``repeats``, ``noise_floor`` and where the candidates run, so a
    careful re-tune is never served a quick result."""
    _check_mode(mode)
    if mode == "cost_model":
        key = (spec, mode, epilogue, device)
    else:
        measure_on = resolve_device(measure_on)
        key = (spec, mode, repeats, noise_floor, epilogue, device,
               str(measure_on))
    if key not in _CACHE:
        if mode == "measured":
            _CACHE[key] = measured_select(
                spec, repeats=repeats, noise_floor=noise_floor,
                epilogue=epilogue, measure_on=measure_on, device=device)
        else:
            _CACHE[key] = cost_model_select(spec, device=device,
                                            epilogue=epilogue)
    return _CACHE[key]


# ----------------------------------------------------------------------
# Block-level candidates: a fused kernel against the per-layer chain.


def block_constituents(bspec: FusedBlockSpec, *, epilogue=True,
                       device=REFERENCE_DEVICE):
    """The per-layer Choices the fused block competes against."""
    return [cost_model_select(cs, device=device, epilogue=epilogue)
            for _, cs in bspec.conv_specs()]


def block_baseline_time(bspec: FusedBlockSpec, *, epilogue=True,
                        device=REFERENCE_DEVICE) -> float:
    """Roofline time of the unfused path: the tuned constituents plus the
    separate shortcut-add pass."""
    t = sum(c.est_time for c in block_constituents(
        bspec, epilogue=epilogue, device=device))
    return t + bspec.residual_pass_bytes / device.mem_bw


def _block_candidates(bspec: FusedBlockSpec, epilogue=True,
                      device=REFERENCE_DEVICE):
    """(algorithm, params, bytes, flops, on-chip working set) of the fused
    kernel: the constituents' bytes less ``saved_bytes``, plus the
    shortcut read for a residual conv."""
    el = bspec.element_size
    constituents = block_constituents(bspec, epilogue=epilogue,
                                      device=device)
    base_bytes = sum(c.est_bytes for c in constituents)
    flops = sum(c.est_flops for c in constituents)
    B = bspec.batch
    OH, OW = bspec.out_h, bspec.out_w
    P = OH * OW
    cands = []
    if bspec.kind == "residual_conv":
        bts = base_bytes - bspec.saved_bytes + el * B * P * bspec.cout
        hp, wp = bspec.h + bspec.r - 1, bspec.w + bspec.s - 1
        for tk in (128, 256, 512):
            tk = min(tk, bspec.cout)
            vmem = hp * wp * bspec.cin * el \
                + bspec.r * bspec.s * bspec.cin * tk * el \
                + 2 * P * tk * el + P * tk * ACC_BYTES
            cands.append(("fused_residual_conv", (("block_k", tk),),
                          bts, flops, vmem))
            if tk == bspec.cout:
                break
        return cands
    bts = base_bytes - bspec.saved_bytes
    hp = (OH - 1) * bspec.stride + bspec.r
    wp = (OW - 1) * bspec.stride + bspec.s
    if bspec.expanded:
        tms = [bspec.mid] + [t for t in (512, 256, 128)
                             if t < bspec.mid and bspec.mid % t == 0]
    else:
        tms = [bspec.mid]
    for tm in tms:
        vmem = el * (bspec.h * bspec.w * bspec.cin + bspec.cin * tm
                     + hp * wp * tm + bspec.r * bspec.s * tm
                     + tm * bspec.cout + P * tm) \
            + ACC_BYTES * P * (tm + bspec.cout)
        cands.append(("fused_inverted_residual", (("block_m", tm),),
                      bts, flops, vmem))
    return cands


@functools.lru_cache(maxsize=None)
def select_block(bspec: FusedBlockSpec, mode: str = "cost_model", *,
                 epilogue=True, device=REFERENCE_DEVICE):
    """Fused-vs-per-layer decision for one block site -> Choice | None
    (None keeps the per-layer plan there). Memoised; cost-model in both
    modes, as in the reference."""
    _check_mode(mode)
    best = None
    for algo, params, bts, flops, vmem in _block_candidates(
            bspec, epilogue, device=device):
        if vmem > device.onchip_bytes:
            continue
        t = max(flops / device.peak_flops, bts / device.mem_bw)
        if best is None or t < best.est_time:
            best = Choice(algo, params, t, bts, flops, vmem)
    baseline = block_baseline_time(bspec, epilogue=epilogue, device=device)
    if best is not None and best.est_time >= baseline:
        best = None  # fusion saves nothing here: keep per-layer
    return best


# ----------------------------------------------------------------------
# Tuning plans: tune once, serialise, deploy many times.

PLAN_VERSION = 2  # v2 adds the optional "blocks" section
_READABLE_VERSIONS = (1, 2)


@dataclass
class TuningPlan:
    """Per-layer tuned choices for one network: ``choices``/``specs`` per
    conv site, ``block_choices``/``block_specs`` per fused block site
    (``<block>.block``)."""
    mode: str = "cost_model"
    specs: dict[str, ConvSpec] = field(default_factory=dict)
    choices: dict[str, Choice] = field(default_factory=dict)
    block_specs: dict[str, FusedBlockSpec] = field(default_factory=dict)
    block_choices: dict[str, Choice] = field(default_factory=dict)

    def algorithms(self) -> dict[str, str]:
        return {name: ch.algorithm for name, ch in self.choices.items()}

    def block_algorithms(self) -> dict[str, str]:
        return {name: ch.algorithm
                for name, ch in self.block_choices.items()}

    def to_json(self) -> str:
        layers = {name: {"spec": asdict(self.specs[name]),
                         "choice": self.choices[name].to_dict()}
                  for name in self.specs}
        blocks = {name: {"spec": asdict(self.block_specs[name]),
                         "choice": self.block_choices[name].to_dict()}
                  for name in self.block_specs}
        return json.dumps({"version": PLAN_VERSION, "mode": self.mode,
                           "layers": layers, "blocks": blocks}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TuningPlan":
        d = json.loads(text)
        if d.get("version") not in _READABLE_VERSIONS:
            raise ValueError(f"unsupported plan version {d.get('version')!r}")
        plan = cls(mode=d["mode"])
        for name, layer in d["layers"].items():
            plan.specs[name] = ConvSpec(**layer["spec"])
            plan.choices[name] = Choice.from_dict(layer["choice"])
        for name, block in d.get("blocks", {}).items():  # absent in v1
            plan.block_specs[name] = FusedBlockSpec(**block["spec"])
            plan.block_choices[name] = Choice.from_dict(block["choice"])
        return plan

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "TuningPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def xla_fallback_plan(named_specs, mode: str = "cost_model") -> TuningPlan:
    """Every site on the ``xla`` escape hatch, costed as the fused
    conv+BN+act variant, and no fused blocks: the degraded-mode plan the
    serving tier deploys when tuned dispatch fails persistently. The
    sites and dtypes are a tuned plan's, so plan validation accepts it."""
    plan = TuningPlan(mode=mode)
    for name, spec in named_specs:
        plan.specs[name] = spec
        plan.choices[name] = xla_choice(spec, epilogue=True)
    return plan


def build_plan(named_specs, mode: str = "cost_model", *, repeats=3,
               noise_floor=0.5, epilogue=False, block_specs=None,
               device=REFERENCE_DEVICE, measure_on=None) -> TuningPlan:
    """Tune every (name, ConvSpec) into a TuningPlan; with ``block_specs``
    ((name, FusedBlockSpec) pairs) also decide which blocks to fuse.
    Every conv site keeps its entry either way, so the plan deploys with
    fusion ignored. ``repeats``, ``noise_floor`` and ``measure_on`` matter
    in measured mode only."""
    plan = TuningPlan(mode=mode)
    for name, spec in named_specs:
        plan.specs[name] = spec
        plan.choices[name] = select(spec, mode, repeats=repeats,
                                    noise_floor=noise_floor,
                                    epilogue=epilogue, device=device,
                                    measure_on=measure_on)
    for name, bspec in (block_specs or ()):
        choice = select_block(bspec, mode, epilogue=epilogue, device=device)
        if choice is not None:
            plan.block_specs[name] = bspec
            plan.block_choices[name] = choice
    return plan
