"""The spread of the bf16 experimental product's error ratio over many
batches (CPU; imports both packages, as the tests do).

`tests/test_torch_general_l.py::test_experimental_bf16_within_jax_bf16_error`
holds, on three six-graph batches, max |port bf16 - JAX f32| to at most a
bound times max |JAX bf16 - JAX f32|. This script computes that ratio on
`--batches` seeded batches of two graphs and as many of six graphs, with the
test's model (two layers, `8x0e + 4x1e`, the experimental product) and
parameters, and prints the minimum, median, 95th percentile and maximum per
size, and each seed's ratio with `--per-seed`.

    JAX_PLATFORMS=cpu python scripts/bf16_experimental_sweep.py --batches 32
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from jamun_tpu.models.e3conv import E3Conv as JE3Conv  # noqa: E402
from jamun_tpu.utils.testing import make_test_batch as j_make_test_batch  # noqa: E402
from jamun_tpu_torch.models.e3conv import E3Conv  # noqa: E402
from jamun_tpu_torch.params import from_jax_params  # noqa: E402
from jamun_tpu_torch.utils.testing import make_test_batch  # noqa: E402

SIGMA, CUTOFF = 0.04, 0.9
ARCH = dict(tensor_product="experimental", irreps_hidden="8x0e + 4x1e", n_layers=2)
SIZES = {  # graphs: atoms per graph (the test's six-graph batch; two of them)
    2: [10, 8],
    6: [10, 8, 10, 9, 10, 7],
}


def ratio(seed: int, nodes) -> tuple:
    """(port bf16 error / JAX bf16 error, JAX bf16 error / max |f32|) on the
    batch of `seed`, both errors against JAX's f32 forward."""
    batch = dict(num_graphs=len(nodes), max_nodes=10, nodes_per_graph=nodes, max_bonds=20,
                 scale=0.35, seed=seed)
    jb, tb = j_make_test_batch(**batch), make_test_batch(**batch, device="cpu")
    c = np.asarray([np.log(SIGMA) / 4.0], np.float32)
    jm = JE3Conv(**ARCH)
    params = jm.init(jax.random.PRNGKey(0), jb, jnp.asarray(c), CUTOFF)
    rng = np.random.default_rng(10)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p)).astype(np.float32)),
        params)
    ref = np.asarray(jm.apply(params, jb, jnp.asarray(c), CUTOFF), np.float64)
    jbf = JE3Conv(**ARCH, dtype=jnp.bfloat16)
    jerr = np.abs(np.asarray(jbf.apply(params, jb, jnp.asarray(c), CUTOFF), np.float64) - ref).max()
    tm = E3Conv(**ARCH, dtype="bfloat16", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tm(tb, torch.from_numpy(c), CUTOFF).to(torch.float64).numpy()
    return float(np.abs(got - ref).max() / jerr), float(jerr / np.abs(ref).max())


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", type=int, default=32)
    parser.add_argument("--per-seed", action="store_true")
    args = parser.parse_args()
    torch.set_num_threads(2)
    out = {}
    for graphs, nodes in SIZES.items():
        rows = [ratio(seed, nodes) for seed in range(args.batches)]
        r = np.asarray([x[0] for x in rows])
        out[f"{graphs} graphs"] = dict(
            batches=len(r), min=float(r.min()), median=float(np.median(r)),
            p95=float(np.percentile(r, 95)), max=float(r.max()), argmax_seed=int(r.argmax()),
            jax_bf16_rel_err_max=float(max(x[1] for x in rows)),
            **({"per_seed": [round(x, 4) for x in r.tolist()]} if args.per_seed else {}),
        )
        print(json.dumps({f"{graphs} graphs": out[f"{graphs} graphs"]}), flush=True)


if __name__ == "__main__":
    main()
