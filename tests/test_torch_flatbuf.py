"""PyTorch port: flat-buffer packing.  Round trip is exact; the used
columns per dtype group (``GroupLayout.size``) equal the JAX package's;
padding follows the port's kernel (a multiple of 8 elements), not the
TPU tile, so ``padded`` is not compared."""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as JF
from repro_torch.core import flatbuf as TF


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(                     # noqa: E731
        rng.standard_normal((n,) + s).astype(np.float32))
    return {"w": f32(8, 16), "b": f32(4),
            "h": f32(3, 5, 2).to(torch.bfloat16), "s": f32(7)}


@pytest.mark.parametrize("n", [1, 4, 8])
def test_round_trip_is_exact_and_rows_aligned(n):
    tree = _tree(n)
    layout, bufs = TF.pack(tree)
    assert [b.dtype for b in bufs] == [torch.float32, torch.bfloat16]
    for g, b in zip(layout.groups, bufs):
        assert b.shape == (n, g.padded) and b.is_contiguous()
        assert g.padded % TF.PAD_MULTIPLE == 0 and g.padded >= g.size
        assert (g.padded * b.element_size()) % 16 == 0     # row alignment
        assert torch.count_nonzero(b[:, g.size:]) == 0      # zero padding
        # no key of this tree names a layer: one scale group a leaf
        assert [s.scale_group for s in g.slots] == list(range(len(g.slots)))
        assert len(g.scale_groups) == len(g.slots)
    out = TF.unpack(layout, bufs)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert torch.equal(out[k], tree[k])
    # unpack gives views into the buffers, no copies
    assert out["w"].untyped_storage().data_ptr() == \
        bufs[0].untyped_storage().data_ptr()


def test_tuple_payload_packs_into_one_group_per_dtype():
    a, b = _tree(4, 1), _tree(4, 2)
    layout, bufs = TF.pack((a, b))
    assert len(bufs) == 2
    back = TF.unpack(layout, bufs)
    assert isinstance(back, tuple) and len(back) == 2
    for got, want in zip(back, (a, b)):
        for k in want:
            assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("n", [4, 8])
def test_group_sizes_match_jax(n):
    tree = _tree(n)
    jtree = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}
    jl = JF.layout_of(jtree)
    tl = TF.layout_of(tree)
    assert tl.n == jl.n == n and tl.n_leaves == jl.n_leaves
    jsizes = {str(g.dtype): g.size for g in jl.groups}
    tsizes = {str(g.dtype).replace("torch.", ""): g.size for g in tl.groups}
    assert tsizes == jsizes
    for g in tl.groups:
        assert sorted(s.size for s in g.slots) == sorted(
            s.size for s in jl.group_for(
                jnp.bfloat16 if g.dtype == torch.bfloat16
                else jnp.float32).slots)
    assert TF.wire_bytes_per_round(tl) == sum(
        g.padded * g.dtype.itemsize for g in tl.groups)


def test_layout_is_cached_and_validated():
    tree = _tree(4)
    assert TF.layout_of(tree) is TF.layout_of(_tree(4, 9))
    with pytest.raises(ValueError, match="leading node axis"):
        TF.layout_of({"a": torch.zeros(4, 2), "b": torch.zeros(3, 2)})
    # int8: 1 byte an element, one f32 scale a leaf plus the padding's,
    # per dtype group; the scale bytes are the reference's
    jtree = {k: jnp.zeros(tuple(v.shape), jnp.bfloat16 if v.dtype ==
                          torch.bfloat16 else jnp.float32)
             for k, v in tree.items()}
    layout = TF.layout_of(tree)
    split = TF.wire_bytes_split(layout, "int8")
    assert split["payload"] == sum(g.padded for g in layout.groups)
    assert split["scales"] == 4 * (len(tree) + 2) == JF.wire_bytes_split(
        JF.layout_of(jtree), "int8")["scales"]


def test_pack_holds_no_reference_cycle():
    """Packing and unpacking leave no reference cycle behind: with the
    garbage collector off, the tree's tensors die with their last
    reference.  (A recursive closure in tree_flatten held every leaf in a
    cycle: on the card a mix kept payload-sized buffers alive until the
    collector ran, 18 GB after a full-width training run.)"""
    gc.collect()
    gc.disable()
    try:
        tree = (_tree(4, 1), _tree(4, 2))
        refs = [weakref.ref(v) for part in tree for v in part.values()]
        layout, bufs = TF.pack(tree)
        back = TF.unpack(layout, bufs)
        ref_buf = weakref.ref(bufs[0])
        del tree, bufs, back
        assert all(r() is None for r in refs) and ref_buf() is None
    finally:
        gc.enable()
