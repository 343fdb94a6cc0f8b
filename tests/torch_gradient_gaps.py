"""How far the step test's gradients move when only the summation order
changes. Runs on the CPU in float32.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_gradient_gaps.py          # ~4 min
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_gradient_gaps.py threads  # ~5 min

The default mode, at the hard mask of tests/test_torch_step.py, prints the
three leaves with the largest max|dg| / max|g| for four pairs of gradients:
JAX with its `lax` conv lowering against its default one, the port with
F.conv3d in place of its plain im2col conv against the port as it is, and
each port variant against JAX.

`threads` runs the step test's own step (its fixture's two halves) with
torch pinned to 1, 2, 4 and 8 intra-op threads, and prints for each count the
gap of every leaf that test_gradients_match holds to the JAX gradient
(largest first, in the test's measure max|g - r| / max|r|), then the largest
gap over all counts.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as fn

import anatomask_torch.ops.conv3x3 as conv3x3
import test_torch_step as step_test
from anatomask_tpu.ssl.spark import spark_loss as jax_spark_loss
from anatomask_torch.convert import spark_state_dict_from_jax
from anatomask_torch.ssl.spark import spark_loss
from torch_parity import (BATCH, DIMS, jax_build_spark_model, jax_params, mask_nd, mask_port,
                          port_model, tiny_configs, to_ncdhw)


def thread_gaps(counts=(1, 2, 4, 8)):
    ref, params, ema_params, x, len_loss = step_test.jax_reference()
    worst = {}
    for n in counts:
        got = step_test.port_step(params, ema_params, x, len_loss, ref["noise"], threads=n)
        gaps = sorted(((float(np.abs(g - r).max() / np.abs(r).max()), name)
                       for name, g, r in step_test._pairs(ref["grads"], got["student"], "grad")
                       if np.abs(r).max() > 0 and not step_test._CANCELLED.fullmatch(name)),
                      reverse=True)
        print(f"threads {n}: loss {got['loss']!r}")
        for gap, name in gaps:
            print(f"  {gap:.4e} {name}")
            worst[name] = max(worst.get(name, 0.0), gap)
    name = max(worst, key=worst.get)
    print(f"largest gap over {counts} threads: {worst[name]:.4e} ({name})")


def main():
    ref, _ = step_test.both_steps.__wrapped__()
    keep = ref["hard"].astype(bool)
    jcfg, tcfg = tiny_configs(DIMS, step_test.STEP_PATCH)
    jmodel = jax_build_spark_model(jcfg)
    params = jax_params(jmodel, seed=21)
    x = np.random.RandomState(23).rand(BATCH, *step_test.STEP_PATCH, 1).astype(np.float32)

    def jax_grads():
        def loss_fn(p):
            inp, rec = jmodel.apply({"params": p}, jnp.asarray(x), mask_nd(keep))
            return jax_spark_loss(inp, rec, mask_nd(keep))[0]
        g = jax.jit(jax.grad(loss_fn))(params)
        tree = spark_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g))
        return {k: v.numpy() for k, v in tree.items()}

    def port_grads():
        model = port_model(params, tcfg)
        inp, rec = model(to_ncdhw(x), mask_port(keep))
        spark_loss(inp, rec, mask_port(keep))[0].backward()
        return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                for k, p in model.named_parameters()}

    jax_default = jax_grads()
    os.environ["ATK_CONV_LOWERING"] = "lax"  # read when the step is traced
    jax_lax = jax_grads()
    del os.environ["ATK_CONV_LOWERING"]
    port_plain = port_grads()
    conv3x3.conv3d_3x3_plain = lambda xs, w: fn.conv3d(
        xs.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), None, 1, 1
    ).permute(0, 2, 3, 4, 1).contiguous()
    port_library = port_grads()

    def worst(a, b):
        gaps = [(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()), k) for k in b
                if np.abs(b[k]).max() > 0 and not step_test._CANCELLED.fullmatch(k)]
        return sorted(gaps, reverse=True)[:3]

    for label, a, b in (("JAX lax lowering vs JAX default", jax_lax, jax_default),
                        ("port F.conv3d vs port plain", port_library, port_plain),
                        ("port plain vs JAX default", port_plain, jax_default),
                        ("port F.conv3d vs JAX default", port_library, jax_default)):
        print(f"{label}: " + ", ".join(f"{k} {g:.3e}" for g, k in worst(a, b)))


if __name__ == "__main__":
    thread_gaps() if sys.argv[1:] == ["threads"] else main()
