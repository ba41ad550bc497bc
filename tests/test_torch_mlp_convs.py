"""The faithful Mlp conv pair (kernel K6's plain version) against the JAX
package's fused_mlp_convs in interpret mode and against its Mlp module.

Small geometry: B = 2, s = 8 (HW = 64), hidden 32, dim 8.  The weights come
from a numpy seed into the flax Mlp's tree and reach the port's `Mlp` through
`weights.module_from_jax` (its dw / pw leaf renaming and HWIO → OIHW conv
copy).  Tolerances: rtol 1e-4, atol 1e-5 (float32 in other summation orders;
the JAX kernel's erf is an A-S 7.1.26 polynomial within 1.5e-7 of erf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as jax_pgrm
from dpmn_tpu.ops.pallas_mlp import fused_mlp_convs
from dpmn_tpu_torch.models.pgrm import Mlp
from dpmn_tpu_torch.ops import mlp_convs as MC
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables

B, S, HIDDEN, DIM = 2, 8, 32, 8
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def case():
    """The flax Mlp, its variables, the port Mlp carrying them, the Mlp input
    and the conv pair's input (the gelu(fc1(.)) activation)."""
    rng = np.random.RandomState(0)
    x = rng.randn(B, S * S, DIM).astype(np.float32)
    hid = rng.randn(B, S * S, HIDDEN).astype(np.float32)
    jm = jax_pgrm.Mlp(hidden=HIDDEN, out=DIM, grid=(S, S))
    variables = init_variables(jm, 1, jnp.asarray(x))
    port = Mlp(DIM, HIDDEN, (S, S)).eval()
    module_from_jax(port, variables)
    return jm, variables, port, x, hid


def test_plain_matches_jax_kernel(case):
    _, variables, port, _, hid = case
    p = variables["params"]
    ref = fused_mlp_convs(jnp.asarray(hid), p["dw_kernel"], p["dw_bias"], p["pw_kernel"], p["pw_bias"], S,
                          interpret=True)
    before = MC.mlp_convs_counter.launches
    with torch.no_grad():
        out = MC.mlp_convs(torch.from_numpy(hid), port.dwconv.weight, port.dwconv.bias, port.pwconv.weight,
                           port.pwconv.bias)
    assert MC.mlp_convs_counter.launches == before  # a CPU tensor runs the plain version
    assert out.shape == (B, S * S, HIDDEN)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_mlp_runs_the_plain_version_and_matches_flax(case):
    """The port's faithful Mlp is fc1 → gelu → mlp_convs_plain → fc2, and
    equals the flax Mlp's faithful branch."""
    jm, variables, port, x, _ = case
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = port(xt)
        mid = MC.mlp_convs_plain(torch.nn.functional.gelu(port.fc1(xt)), port.dwconv.weight, port.dwconv.bias,
                                 port.pwconv.weight, port.pwconv.bias)
        np.testing.assert_array_equal(out.numpy(), port.fc2(mid).numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(variables, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_non_square_token_count_raises():
    x = torch.zeros(1, 60, 32)
    with pytest.raises(ValueError, match="perfect square"):
        MC.mlp_convs(x, torch.zeros(32, 1, 3, 3), torch.zeros(32), torch.zeros(32, 32, 1, 1), torch.zeros(32))
