"""The committed glyph atlas equals the JAX package's build_atlas for its
default font, and the port's generator rebuilds it.  Needs pygame (skipped
where it is missing)."""

import numpy as np
import pytest

from dpmn_tpu_torch.data.glyph_atlas import ATLAS_PATH


def test_committed_atlas_equals_jax_build_atlas():
    pytest.importorskip("pygame")
    from dpmn_tpu.data.glyph_atlas import build_atlas

    atlas, tops, bots, advs, inkls, inkrs, sel = build_atlas((32, 128), None)
    z = np.load(ATLAS_PATH)
    assert z["atlas"].dtype == np.uint8
    np.testing.assert_array_equal(z["atlas"].astype(np.float32), atlas)
    for key, ref in (("tops", tops), ("bots", bots), ("advs", advs), ("inkls", inkls), ("inkrs", inkrs)):
        np.testing.assert_array_equal(z[key], ref)
    np.testing.assert_array_equal(z["sel"], np.stack(sel))


def test_port_generator_rebuilds_the_committed_atlas():
    pytest.importorskip("pygame")
    from dpmn_tpu.data.glyph import _DEFAULT_FONT
    from dpmn_tpu_torch.data.build_atlas import build_atlas

    built = build_atlas(_DEFAULT_FONT)
    z = np.load(ATLAS_PATH)
    assert sorted(built) == sorted(z.files)
    for key in z.files:
        np.testing.assert_array_equal(built[key], z[key])
