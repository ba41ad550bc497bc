"""Shared helpers of the dpmn_tpu_torch parity tests (no tests of its own).

Weights for both packages come from a numpy seed: `random_variables` fills a
flax variable tree (shapes from jax.eval_shape, so nothing is initialized)
with scaled random values by leaf name, and the port takes the same numbers
through dpmn_tpu_torch.weights.  Images cross as numpy arrays, NHWC for the
JAX package and NCHW for the port.
"""

import os

import jax
import numpy as np
import torch
import torch._dynamo  # noqa: F401

# torch.optim imports torch._dynamo (and with it torch.distributed) on its
# first use, and that import inspects the source of every loaded module.
# Tests that run the reference tree install stub modules whose module-level
# __getattr__ answers any name, `__file__` included, which breaks that
# inspection (tests/reference_bridge.py).  Importing it here, while the
# port's test files are collected, puts it ahead of any stub.

# Under pytest-xdist each worker is one of several processes on the host's
# cores.  torch's OpenMP pool takes every core in each of them, and its
# threads spin while they wait, so workers running torch-heavy tests at once
# slow each other down many times over; each worker takes its share instead.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def random_variables(shape_tree, seed: int):
    """numpy leaves for a tree of jax.ShapeDtypeStruct, scaled so activations
    stay O(1): kernels ~ N(0, 1/fan_in), biases ~ 0.1 N(0, 1), norm scales
    ~ 1 + 0.1 N(0, 1), BatchNorm variances in [0.5, 1.5], RNN weights
    U(±1/sqrt(H)), relative-position tables 0.1 N(0, 1), residual weights
    1 + 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shape_tree)
    leaves = []
    hidden = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1].startswith("w_hh_"):
            hidden["/".join(keys[:-1])] = leaf.shape[0]
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        name, shape = keys[-1], tuple(leaf.shape)
        if name.endswith("kernel"):
            v = rng.randn(*shape) / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        elif name == "scale" or name.startswith("weight_list"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "a":
            v = 0.25 + 0.05 * rng.randn(*shape)
        elif name[:5] in ("w_ih_", "w_hh_", "b_ih_", "b_hh_"):
            k = 1.0 / np.sqrt(hidden["/".join(keys[:-1])])
            v = rng.uniform(-k, k, shape)
        elif name == "in_proj_weight":
            v = rng.randn(*shape) / np.sqrt(shape[1])
        elif name in ("embedding", "init_factor"):
            v = rng.randn(*shape)
        elif name.startswith("relative_position_bias_table"):
            v = 0.1 * rng.randn(*shape)
        else:  # biases, BatchNorm means
            v = 0.1 * rng.randn(*shape)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def init_variables(module, seed: int, *args, **kwargs):
    """Random numpy variables of a flax module, without running its init."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return random_variables(shapes, seed)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def aster_variables(seed: int):
    """Random variables of dpmn_tpu's full-width ASTER, with its STN started
    as the reference starts it: the control points on the margin-0.01
    rectangle (stn_fc2's bias), moved by a small random kernel, so that the
    TPS warp is a real near-identity warp instead of a collapse to one
    corner."""
    import jax.numpy as jnp

    from dpmn_tpu.models.aster import RecognizerBuilder
    from dpmn_tpu.models.stn import init_ctrl_points

    variables = init_variables(RecognizerBuilder(), seed, jnp.zeros((1, 32, 100, 3)), train=False)
    fc2 = variables["params"]["stn_head"]["Dense_1"]
    fc2["bias"] = init_ctrl_points(20).reshape(-1)
    fc2["kernel"] = 0.1 * fc2["kernel"]
    return variables
