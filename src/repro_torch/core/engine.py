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
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.core import autotune
from repro_torch.core.autotune import TuningPlan
from repro_torch.core.convspec import ConvSpec
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


def resolve_device(device) -> torch.device:
    """``device`` as given, else the card; no card and no ``device``
    raises rather than running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card by default; pass "
            "device=\"cpu\" to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


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
    the weights are drawn from ``seed``.
    """

    def __init__(self, cfg, params=None, seed=0, algorithm="auto",
                 plan=None, device=None, tune_mode="cost_model"):
        # the models import core, so core reads them at call time
        from repro_torch.models.registry import cnn_module
        from repro_torch.models.spec import init_params

        if cfg.family != "cnn":
            raise ValueError(f"InferenceEngine runs CNNs, not {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
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

    def tune(self, mode="cost_model") -> TuningPlan:
        """Build the TuningPlan, costing each site as its fused
        conv+BN+act variant (what the forward dispatches)."""
        return autotune.build_plan(self._conv_specs(), mode=mode,
                                   epilogue=True,
                                   block_specs=self._block_specs())

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

    def run(self, image):
        """image: (H, W, 3) single image -> logits (classes,) on the
        engine's device."""
        x = torch.as_tensor(image, device=self.device)
        with torch.inference_mode():
            return self._model.forward(self.params, self.cfg, x[None],
                                       algorithm=self.algorithm,
                                       plan=self._choices,
                                       winograd_u=self.winograd_u)[0]

    def run_batch(self, images):
        """images: (B, H, W, 3) -> logits (B, classes). Each element runs
        the identical single-image computation of ``run``, so the result
        is bitwise equal to B calls of ``run``."""
        xs = torch.as_tensor(images, device=self.device)
        return torch.stack([self.run(x) for x in xs])

    def traffic_report(self):
        """Per-layer cost-model bytes/flops for every planned conv site."""
        return self.reports
