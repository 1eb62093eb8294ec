"""K5's edge semantics on the CPU: the plain twin ``tile_topk_plain`` (what
csrc/tile_topk.cu is held to on the card) against the reference's K5
(``_tile_topk_kernel``) in interpret mode, on adversarial tiles.

The inputs (``chip_smoke.adversarial_tile_inputs``) make every score exact
in f32, so the two backends' different summation orders give the same bits
and rows and score bits are compared exactly: duplicated rows and a zero
query row (exact ties: the first column wins), masked rows, a fully masked
tile (every slot column 0 at -inf), and a tile with three finite rows, so
kk above 3 reaches the -inf column-0 padding. Three tiles of 2048 rows,
d = 128, kk <= 64, on a bf16 slab and on an f32 slab (the reference's K5
then takes f32 products and sums; the inputs are exact in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from frankensearch_tpu_torch.ops import topk_scan as tts
from tests.test_torch_int8_scan import _ref_tile_topk as ref_tile_topk

N_TILES, D = 3, 128
#: the slab types: the reference's array type beside the port's
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def tiles():
    return chip_smoke.adversarial_tile_inputs(N_TILES, D, 5, seed=3)


@pytest.mark.parametrize("kk", [1, 2, 7, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_topk_twin_equals_reference_on_adversarial_tiles(tiles, dtype, kk):
    slab, q, mask = tiles
    jdt, tdt = DTYPES[dtype]
    want_s, want_i = ref_tile_topk(jnp.asarray(slab, jdt), q, mask, kk)
    got_s, got_i = tts.tile_topk(torch.from_numpy(slab).to(tdt), torch.from_numpy(q), torch.from_numpy(mask), kk)
    assert got_s.shape == (N_TILES, kk, 5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s.view(np.uint32))
    # the masked tile: column 0 at -inf throughout; the 3-row tile pads after 3
    assert (got_i[1].numpy() == 2048).all() and np.isneginf(got_s[1].numpy()).all()
    live = min(kk, 3)
    assert set(got_i[2, :live].numpy().ravel()) <= {4096 + 5, 4096 + 700, 4096 + 2047}
    assert (got_i[2, live:].numpy() == 4096).all() and np.isneginf(got_s[2, live:].numpy()).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_topk_ties_come_out_column_ascending(tiles, dtype):
    """The zero query row ties every live column of tile 0: the twin lists
    them in column order, as the reference's first-column argmax does."""
    slab, q, mask = tiles
    got_s, got_i = tts.tile_topk(torch.from_numpy(slab).to(DTYPES[dtype][1]), torch.from_numpy(q),
                                 torch.from_numpy(mask), 64)
    live = np.flatnonzero(mask[:2048] == 0.0)[:64]
    np.testing.assert_array_equal(got_i[0, :, 1].numpy(), live)
    assert (got_s[0, :, 1].numpy() == 0.0).all()
    dup = got_s[0, :, 0].numpy()  # query 0: equal scores keep ascending columns
    cols = got_i[0, :, 0].numpy()
    same = dup[1:] == dup[:-1]
    assert same.any() and (cols[1:][same] > cols[:-1][same]).all()
