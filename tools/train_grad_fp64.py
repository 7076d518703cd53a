"""How far the reference's fp32 train gradient lies from its own fp64
gradient, beside the port's fp32 gradient, for a tiny config on the
batch of ``tests/test_torch_train.py``'s ``_batch``.

The reference is run twice in one process with ``jax_enable_x64``: as
written (fp32), then with every fp32 cast, weight and constant widened
to fp64 (``jnp.float32`` rebound to ``jnp.float64`` for the run). The
weights are the reference's ``init_state`` draw, which depends on
``PYTHONHASHSEED`` (a leaf is seeded by ``hash`` of its path), so the
seed is printed; run it under several to see the spread.

    PYTHONHASHSEED=1 PYTHONPATH=src:tests JAX_PLATFORMS=cpu \\
        python tools/train_grad_fp64.py --arch jamba-1.5-large-398b

Prints one JSON line: the worst leaf and its max|a - b| / max|b| for the
reference's fp32 and the port's fp32 against the reference's fp64, and
for the port against the reference in fp32.
"""
import argparse
import json
import os

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_train import _batch, _jgrads, _rel, _state  # noqa: E402
from test_torch_train_families import port_draw  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import tiny_variant as jtiny  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.configs import tiny_variant as ttiny  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models.spec import flatten, unflatten  # noqa: E402


def worst(a, b):
    errs = {k: _rel(a[k], b[k]) for k in b}
    k = max(errs, key=errs.get)
    return {"leaf": k, "max_rel_err": errs[k]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference-draw", action="store_true")
    args = ap.parse_args()
    jcfg, tcfg = jtiny(jget(args.arch)), ttiny(tget(args.arch))
    if args.reference_draw:
        jstate, tstate = _state(jcfg, args.seed)
    else:
        jstate = port_draw(tcfg, args.seed)
        tstate = unflatten(params_from_reference(jstate))
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g32 = flatten(jax.tree.map(np.asarray,
                               _jgrads(jcfg)(jstate["params"], jb)))
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        p64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                           jstate["params"])
        g64 = flatten(jax.tree.map(np.asarray, _jgrads(
            jcfg.replace(dtype="float64"))(p64, jb)))
    finally:
        jnp.float32 = f32
    g64 = {k: v.astype(np.float64) for k, v in g64.items()}
    tg = flatten(steps.loss_and_grads(
        tcfg, tstate["params"],
        {k: torch.from_numpy(v) for k, v in batch.items()})[0])
    print(json.dumps({
        "arch": jcfg.name, "seed": args.seed,
        "draw": "reference" if args.reference_draw else "port",
        "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED"),
        "reference_fp32_vs_fp64": worst(g32, g64),
        "port_fp32_vs_reference_fp64": worst(tg, g64),
        "port_fp32_vs_reference_fp32": worst(tg, g32)}))


if __name__ == "__main__":
    main()
