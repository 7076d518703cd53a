"""Single-image CNN inference engine (``repro/core/engine.py``).

The paper's tune-once/run-many flow:
  1. the model module's ``conv_specs`` enumerates every conv site;
  2. the autotuner turns them into a ``TuningPlan`` (one Choice per site,
     costed as the fused conv+BN+act variant), and decides which blocks
     to fuse from ``block_specs``;
  3. every forward dispatches each site to its tuned kernel;
  4. plans serialise to JSON (``save_plan``; ``plan=`` takes a path), and
     the JSON is the reference package's, so a plan tuned by either
     package deploys on the other.

Weights are frozen at inference, so each Winograd site's filter transform
U = G g Gᵀ is computed once per build (``winograd_u``) and every forward
reuses it; a forced engine has no plan and computes U per call, in fp32,
as the reference does.

A storage-only precision variant (``param_dtype`` ≠ ``dtype``) keeps its
weights as stored in ``model`` and casts each conv filter to the compute
dtype once, at build, in ``params``: exact where storage is narrower, one
rounding where it is wider (the reference's kernels promote such a site to
fp32 instead and round on the write; the two differ within
``tolerance(dtype)``). Folded-BN vectors stay as stored (the kernels read
them as fp32), the classifier head promotes as jnp does, and the U cache
is computed from the weights as stored.

The engine runs on the card unless the caller passes ``device="cpu"``,
where every kernel site runs its plain PyTorch version.

On the card the engine replays CUDA graphs, the port's counterpart of the
reference's ``jax.jit``: the first ``run`` of an image shape captures the
batch-1 forward, the first ``run_batch`` of a batch size B captures B
batch-1 forwards in sequence (the counterpart of ``lax.map``), and every
call copies its images into the graph's static input, replays, and
returns a clone of the static logits. So a batch is bitwise equal to B
calls of ``run``, and ``trace_count`` counts the batch shapes prepared.
Before a thread's first capture the engine runs one forward on a side
stream: first use builds and loads the kernel library, fills the
wrappers' memoised plans, copies Winograd's G to the card and creates
the thread's cuBLAS and cuDNN handles, none of which a graph can hold. The kernel wrappers' launch counters tick when a forward
is traced (the warm-up and each capture; ``forwards`` counts them),
never on a replay. ``replay=False`` builds an eager engine, the only kind
on the CPU. A capture that fails raises; nothing falls back to eager
dispatch. One lock an engine covers copy-in, replay and clone-out, so
any thread may call it, and all its graphs share one memory pool.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.core import autotune
from repro_torch.core.autotune import TuningPlan
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.device import CAPTURE_LOCK, resolve_device
from repro_torch.core.dtypes import torch_dtype
from repro_torch.kernels import ref

log = logging.getLogger(__name__)


@dataclass
class LayerReport:
    name: str
    spec: ConvSpec
    algorithm: str
    est_time: float
    est_bytes: int
    est_flops: int
    params: tuple = ()


@dataclass
class DeviceFrame:
    """One streaming frame on the engine's device (``device_put_frame``):
    ``x`` is the (1, H, W, C) buffer, ``ready`` the event its copy to the
    card records (None on the CPU). ``run_stream`` consumes it once."""
    x: torch.Tensor
    ready: object = None
    consumed: bool = False


@dataclass
class _Graph:
    """A captured forward: its static input (B, H, W, C) and logits."""
    graph: object
    x: torch.Tensor
    out: torch.Tensor


def compute_params(params, dtype):
    """``params`` with every conv filter (a 4-D ``w``) in ``dtype``; other
    leaves (folded-BN vectors, the classifier head) as stored."""
    out = {}
    for key, v in params.items():
        if isinstance(v, dict):
            out[key] = compute_params(v, dtype)
        elif key == "w" and v.dim() == 4:
            out[key] = v.to(dtype)
        else:
            out[key] = v
    return out


class InferenceEngine:
    """Tune-once, run-many single-image inference.

    ``algorithm="auto"`` tunes a per-layer plan; a concrete algorithm name
    forces every conv site onto it; ``plan=`` (a TuningPlan or a JSON
    path) skips tuning and deploys a saved plan. ``params`` is a nested
    dict of tensors, a flat ``state_dict`` or a network module; by default
    the weights are drawn from ``seed``. ``replay`` (default: on the card)
    replays CUDA graphs; ``replay=False`` dispatches every op eagerly.
    """

    def __init__(self, cfg, params=None, seed=0, algorithm="auto",
                 plan=None, device=None, tune_mode="cost_model",
                 replay=None):
        # the models import core, so core reads them at call time
        from repro_torch.models.registry import cnn_module
        from repro_torch.models.spec import init_params

        if cfg.family != "cnn":
            raise ValueError(f"InferenceEngine runs CNNs, not {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.replay = self.device.type == "cuda" if replay is None \
            else bool(replay)
        if self.replay and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on the card, not on "
                             f"{self.device}: pass replay=False")
        self._lock = threading.Lock()
        self._runs: dict[tuple, _Graph] = {}  # image key -> batch-1 graph
        # batch key -> its graph (None where eager): run_batch's shapes
        self._batches: dict[tuple, _Graph | None] = {}
        self._local = threading.local()  # per thread: signatures warmed
        self._pinned: dict[tuple, list] = {}  # frame key -> [buf, event]s
        self._pin_lock = threading.Lock()
        if self.device.type == "cuda":
            self._copies = torch.cuda.Stream(self.device)  # frames in
        if self.replay:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
            self._done = torch.cuda.Event()  # after the last clone-out
        self.forwards = 0  # single-image forwards traced through the model
        self._model = cnn_module(cfg)
        if params is None:
            params = init_params(self._model.model_specs(cfg), seed,
                                 cfg.param_dtype)
        elif isinstance(params, nn.Module):
            params = params.state_dict()
        self.model = self._model.Network(cfg, params).to(self.device)
        self.params = compute_params(self.model.params(),
                                     torch_dtype(cfg.dtype))
        self.algorithm = algorithm
        if plan is not None and not isinstance(plan, TuningPlan):
            plan = TuningPlan.load(plan)  # a path: tune-once/deploy-many
        if plan is not None:
            self._validate_plan(plan)
        elif algorithm == "auto":
            plan = self.tune(mode=tune_mode)
        self.plan = plan
        self.reports = self._reports_from_plan(plan) if plan else []
        self.winograd_u = self._winograd_cache(plan) if plan else {}
        # per-conv choices plus the block-fusion decisions; `<block>.block`
        # keys are disjoint from conv-site keys
        self._choices = {**plan.choices, **plan.block_choices} \
            if plan is not None else None

    # ------------------------------------------------------------------
    # plan construction

    def _conv_specs(self):
        return self._model.conv_specs(self.cfg)

    def _block_specs(self):
        return self._model.block_specs(self.cfg)

    def tune(self, mode="cost_model", **tune_kwargs) -> TuningPlan:
        """Build the TuningPlan, costing each site as its fused
        conv+BN+act variant (what the forward dispatches).
        ``tune_kwargs`` reach ``autotune.build_plan``: ``repeats`` and
        ``noise_floor`` for measured mode, which times the candidates on
        this engine's device unless ``measure_on`` names another."""
        tune_kwargs.setdefault("measure_on", self.device)
        return autotune.build_plan(self._conv_specs(), mode=mode,
                                   epilogue=True,
                                   block_specs=self._block_specs(),
                                   **tune_kwargs)

    def _winograd_cache(self, plan: TuningPlan) -> dict:
        """U = G g Gᵀ for each plan site whose choice is winograd, on the
        engine's device, from the filter as stored and cast to its stored
        dtype (the transform computes in fp32), as the reference has it;
        then widened (exactly) where that is narrower than the compute
        dtype. An fp32 U under a 16-bit compute dtype stays fp32."""
        compute = torch_dtype(self.cfg.dtype)
        stored = self.model.params()
        cache = {}
        with torch.no_grad():
            for name, ch in plan.choices.items():
                if ch.algorithm != "winograd":
                    continue
                node = stored
                try:
                    for part in name.split("."):
                        node = node[part]
                    w = node["w"]
                except (KeyError, TypeError):
                    continue  # plan site not in this param tree: skip
                u = ref.winograd_filter_transform(w).to(w.dtype)
                cache[name] = u.to(torch.promote_types(w.dtype, compute))
        return cache

    def _validate_plan(self, plan: TuningPlan) -> None:
        """A deployed plan must match this network's conv geometry and
        dtype: a plan tuned in fp32 does not deploy onto a bf16 engine."""
        ours = dict(self._conv_specs())
        mismatched = {n for n, spec in plan.specs.items()
                      if n in ours and ours[n] != spec}
        if mismatched:
            raise ValueError(
                f"tuning plan was built for a different network/input "
                f"size/dtype (engine dtype {self.cfg.dtype!r}); "
                f"mismatched specs for {sorted(mismatched)}")
        missing = ours.keys() - plan.specs.keys()
        extra = plan.specs.keys() - ours.keys()
        if missing or extra:
            log.warning("tuning plan coverage mismatch: missing=%s (these "
                        "layers fall back to untuned dispatch) extra=%s "
                        "(ignored)", sorted(missing), sorted(extra))
        our_blocks = dict(self._block_specs())
        bad_blocks = {n for n, bspec in plan.block_specs.items()
                      if n in our_blocks and our_blocks[n] != bspec}
        if bad_blocks:
            raise ValueError(
                f"tuning plan was built for a different network/input "
                f"size/dtype (engine dtype {self.cfg.dtype!r}); "
                f"mismatched block specs for {sorted(bad_blocks)}")

    def save_plan(self, path) -> None:
        if self.plan is None:
            raise ValueError("engine has no plan to save")
        self.plan.save(path)

    @staticmethod
    def _reports_from_plan(plan: TuningPlan):
        return [LayerReport(name, plan.specs[name], ch.algorithm,
                            ch.est_time, ch.est_bytes, ch.est_flops,
                            ch.params)
                for name, ch in plan.choices.items()]

    # ------------------------------------------------------------------

    def _check(self, x, batched):
        """Raise unless ``x`` is (H, W, C), or (B, H, W, C) with
        ``batched``, at the config's size and channels, floating point:
        checked before any capture, so a bad request leaves no graph."""
        img = self.cfg.extra["img"]
        want = (img, img, self.params["stem"]["w"].shape[2])
        shape = tuple(x.shape[1:]) if batched else tuple(x.shape)
        if x.dim() != 3 + batched or shape != want or not x.numel() \
                or not x.is_floating_point():
            raise ValueError(
                f"{self.cfg.name}: images of shape {tuple(x.shape)} and "
                f"dtype {x.dtype}; want {'(B, ' if batched else '('}"
                f"{', '.join(map(str, want))}) floating point")

    def _images(self, images, batched):
        x = torch.as_tensor(images, device=self.device)
        self._check(x, batched)
        return x

    def _forward(self, x):
        """The batch-1 forward: x (1, H, W, C) -> logits (1, classes)."""
        self.forwards += 1
        return self._model.forward(self.params, self.cfg, x,
                                   algorithm=self.algorithm,
                                   plan=self._choices,
                                   winograd_u=self.winograd_u)

    def _forwards(self, xs):
        """B batch-1 forwards in sequence: xs (B, H, W, C) -> (B, classes),
        each row the computation ``run`` dispatches."""
        return torch.stack([self._forward(xs[i:i + 1])[0]
                            for i in range(xs.shape[0])])

    def _warm_up(self, x):
        """One forward on a side stream before a thread's first capture of
        an image signature: what first use does a graph cannot hold (the
        library's build and load, the memoised plans, Winograd's G, and
        the cuBLAS and cuDNN handles, which are per thread)."""
        key = (tuple(x.shape[1:]), x.dtype)
        warm = self._local.__dict__.setdefault("warm", set())
        if key in warm:
            return
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            self._forward(x[:1])
        torch.cuda.current_stream(self.device).wait_stream(self._side)
        warm.add(key)

    def _graph(self, graphs, key, xs):
        """The graph of ``_forwards`` at ``xs``' shape, captured on first
        use; a capture that fails raises and leaves no graph."""
        g = graphs.get(key)
        if g is None:
            static_x = torch.zeros(xs.shape, dtype=xs.dtype,
                                   device=self.device)
            self._warm_up(static_x)
            graph = torch.cuda.CUDAGraph()
            with CAPTURE_LOCK, torch.cuda.graph(
                    graph, pool=self._pool, stream=self._side,
                    capture_error_mode="thread_local"):
                out = self._forwards(static_x)
            g = graphs[key] = _Graph(graph, static_x, out)
        return g

    def _replay(self, g, xs):
        """Copy in, replay, clone out, after the last replay of any of
        this engine's graphs (they share static buffers and a pool)."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self._done)
        g.x.copy_(xs)
        g.graph.replay()
        out = g.out.clone()
        self._done.record(stream)
        return out

    def run(self, image):
        """image: (H, W, C) single image -> logits (classes,) on the
        engine's device."""
        x = self._images(image, batched=False)[None]
        key = (tuple(x.shape), x.dtype)
        with self._lock, torch.inference_mode():
            if not self.replay:
                return self._forward(x)[0]
            return self._replay(self._graph(self._runs, key, x), x)[0]

    def run_batch(self, images):
        """images: (B, H, W, C) -> logits (B, classes). Each element runs
        the identical single-image computation of ``run``, so the result
        is bitwise equal to B calls of ``run``. One graph a distinct B
        (``trace_count``)."""
        xs = self._images(images, batched=True)
        key = (tuple(xs.shape), xs.dtype)
        with self._lock, torch.inference_mode():
            if not self.replay:
                self._batches[key] = None
                return self._forwards(xs)
            return self._replay(self._graph(self._batches, key, xs), xs)

    def trace_count(self) -> int:
        """Distinct batch shapes ``run_batch`` has been prepared for (each
        a captured graph on the card); serving pads batches to
        power-of-two buckets to bound it."""
        with self._lock:
            return len(self._batches)

    @property
    def graphs(self) -> int:
        """CUDA graphs captured so far."""
        with self._lock:
            return len(self._runs) + sum(
                g is not None for g in self._batches.values())

    def device_put_frame(self, image) -> DeviceFrame:
        """Start one streaming frame's copy to the card; returns the
        ``DeviceFrame`` for ``run_stream``. ``image`` is (H, W, C) or
        (1, H, W, C) on the host. It goes through a pinned buffer, then a
        non-blocking copy on a side stream that records the frame's
        event; a pinned buffer is reused only once its last copy's event
        has completed, so a late frame never overwrites one in flight.
        Called at frame arrival, so the copy overlaps the frame in
        compute (the reference donates the buffer instead)."""
        x = torch.as_tensor(image)
        if x.dim() == 4 and x.shape[0] == 1:
            x = x[0]
        self._check(x, batched=False)
        if self.device.type != "cuda":
            return DeviceFrame(x.to(self.device, copy=True)[None])
        ready = torch.cuda.Event()
        with self._pin_lock:
            slots = self._pinned.setdefault((tuple(x.shape), x.dtype), [])
            slot = next((s for s in slots if s[1].query()), None)
            if slot is None:
                slot = [torch.empty(x.shape, dtype=x.dtype,
                                    pin_memory=True), ready]
                slots.append(slot)
            slot[0].copy_(x)
            with torch.cuda.stream(self._copies):
                buf = torch.empty((1, *x.shape), dtype=x.dtype,
                                  device=self.device)
                buf[0].copy_(slot[0], non_blocking=True)
                ready.record(self._copies)
            slot[1] = ready
        return DeviceFrame(buf, ready)

    def run_stream(self, frame: DeviceFrame):
        """One streaming frame -> logits (classes,): waits for the frame's
        copy on the current stream, then runs exactly ``run``'s
        computation, through the same graph. The frame is consumed: a
        second call with it raises, as the reference's donated buffer is
        dead."""
        if frame.consumed:
            raise ValueError("run_stream: frame already consumed; "
                             "device_put_frame each frame anew")
        frame.consumed = True
        x, frame.x = frame.x, None
        if frame.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(frame.ready)
            x.record_stream(stream)
        return self.run(x[0])

    def traffic_report(self):
        """Per-layer cost-model bytes/flops for every planned conv site."""
        return self.reports
