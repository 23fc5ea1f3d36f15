"""MEAN's bfloat16 pretransform (``graphsage_torch.ops.pretransform``): the
exact three-piece split of the float32 weight, the plain version against
the float32 product it replaces, the kernel's layout and launch plan, and
``models.layers.mean_pretransform``'s choice of path.

This file imports no JAX; the card's tests of the kernel are in
``tests/test_torch_kernels.py``.

The bar of the three-piece product against ``torch.matmul(h.float(),
w.T).to(torch.bfloat16)``: identical on at least 99.9% of the elements,
and every element within one bfloat16 ulp of the reference plus 2^-20 of
``|h| @ |w|.T`` there.  Both sum the same exact float32 products in
another order; where a sum cancels, the order alone can move the float32
result across a bfloat16 rounding boundary, which the second term covers.
"""

import numpy as np
import pytest
import torch

from graphsage_torch.models import layers
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import pretransform as pt


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous().view(torch.int32)


def _resum(pieces: torch.Tensor) -> torch.Tensor:
    return (pieces[0].float() + pieces[1].float()) + pieces[2].float()


SPECIAL = [1e-30, -1e-30, 1e30, -1e30, 0.0, -0.0,
           2.0 - 2.0**-23, 1.0 - 2.0**-24, 0.5 - 2.0**-25, -(4.0 - 2.0**-21),
           2.0**-110, 3.0e38, 1.0, -0.75, 2.0**-24 * 3]


def test_pieces_sum_back_to_the_weight_bit_for_bit():
    rng = np.random.RandomState(0)
    xavier = rng.uniform(-0.09, 0.09, (256, 602)).astype(np.float32)
    wide = (rng.randn(64, 97) * np.exp2(rng.randint(-90, 90, (64, 97)))
            ).astype(np.float32)
    for w in (torch.from_numpy(xavier), torch.from_numpy(wide),
              torch.tensor(SPECIAL)):
        pieces = pt.split_weight(w)
        assert pieces.dtype == torch.bfloat16
        assert pieces.shape == (3, *w.shape)
        assert torch.equal(_bits(_resum(pieces)), _bits(w))


def test_pieces_hold_eight_bits_each_largest_first():
    """hi is bf16(w); each later piece is under half an ulp of the one
    before (round to nearest)."""
    w = torch.from_numpy(np.random.RandomState(1).randn(50, 40)
                         .astype(np.float32))
    hi, mid, lo = pt.split_weight(w).float()
    assert torch.equal(hi, w.bfloat16().float())
    nz = mid != 0
    assert (mid.abs() <= 2.0**-8 * hi.abs())[nz].all()
    nz = lo != 0
    assert (lo.abs() <= 2.0**-8 * mid.abs())[nz].all()


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_three_piece_bar(got: torch.Tensor, want: torch.Tensor,
                           h: torch.Tensor, w: torch.Tensor,
                           identical: float = 0.999) -> None:
    """``got`` against ``want`` (both bfloat16): the bar in the module
    docstring."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    absprod = torch.matmul(h.float().abs(), w.float().abs().T)
    diff = (got.float() - want.float()).abs()
    bound = _bf16_ulp(want) + 2.0**-20 * absprod
    assert (diff <= bound).all(), float((diff - bound).max())
    same = (got == want).float().mean().item()
    assert same >= identical, same


@pytest.mark.parametrize("gcn", [False, True])
@pytest.mark.parametrize("k", [602, 128, 10, 1433])
def test_plain_three_pieces_match_the_float32_product(k, gcn):
    rng = np.random.RandomState(k + gcn)
    n, hidden = 1000 + 37, 128          # N not a multiple of 128
    h = torch.from_numpy(rng.randn(n, k).astype(np.float32)).bfloat16()
    fan_in = k if gcn else 2 * k
    a = np.sqrt(6.0 / (fan_in + hidden))
    w = torch.from_numpy(rng.uniform(-a, a, (hidden, fan_in))
                         .astype(np.float32))
    w_part = w if gcn else torch.cat([w[:, :k], w[:, k:]])    # [P, K]
    want = torch.matmul(h.float(), w_part.T).to(torch.bfloat16)
    got = pt.pretransform_plain(h, pt.split_weight(w_part))
    assert_three_piece_bar(got, want, h, w_part)
    with torch.no_grad():
        via_layer = layers.mean_pretransform(w, h, gcn=gcn)
    assert torch.equal(via_layer, got)


def test_plain_pieces_sum_into_one_accumulator_and_round_once():
    """A weight that bfloat16 holds exactly: the product is the float32
    product of the same numbers, rounded once."""
    rng = np.random.RandomState(3)
    h = torch.from_numpy(rng.randn(130, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(48, 64).astype(np.float32)).bfloat16()
    pieces = pt.split_weight(w.float())
    assert not pieces[1:].any()
    assert torch.equal(pt.pretransform_plain(h, pieces),
                       torch.matmul(h.float(), w.float().T).bfloat16())


@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("p,k", [(256, 602), (100, 10), (384, 129)])
def test_packed_pieces_layout(p, k, bn):
    """Slice ks of column tile c is packed[ks, c]: the pieces' rows c * bn
    .. and columns ks * 64 .., zero past P and K, with row r's 16-byte
    chunk j at chunk j ^ (r % 8)."""
    pieces = pt.split_weight(torch.randn(p, k))
    packed = pt.pack_pieces(pieces, bn)
    kt, ct = -(-k // 64), -(-p // bn)
    assert packed.shape == (kt, ct, 3, bn, 64) and packed.is_contiguous()
    full = torch.zeros(3, ct * bn, kt * 64, dtype=torch.bfloat16)
    full[:, :p, :k] = pieces
    for ks in range(kt):
        for c in range(ct):
            block = full[:, c * bn:(c + 1) * bn, ks * 64:(ks + 1) * 64]
            for r in (0, 1, 7, 8, 13, bn - 1):
                for j in range(8):
                    src = (j ^ (r % 8)) * 8
                    assert torch.equal(packed[ks, c, :, r, j * 8:j * 8 + 8],
                                       block[:, r, src:src + 8])


# (h address mod 16, row stride bytes, row bytes, P) -> (unit, bn)
PLANS = {
    "serving layer 1 (602)": ((0, 1204, 1204, 256), (4, 256)),
    "serving layer 2 (128)": ((0, 256, 256, 256), (16, 256)),
    "gcn layer 2": ((0, 256, 256, 128), (16, 128)),
    "cora 1433": ((0, 2866, 2866, 256), (2, 256)),
    "pubmed 500": ((0, 1000, 1000, 256), (8, 256)),
    "narrow hidden": ((0, 256, 256, 32), (16, 64)),
    "wide hidden": ((0, 256, 256, 512), (16, 256)),
    "offset view": ((4, 1204, 1200, 256), (4, 256)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pretransform_plan(name):
    args, want = PLANS[name]
    assert pt.pretransform_plan(*args) == want


def _kernel_args(**change):
    args = dict(h=torch.zeros(10, 6, dtype=torch.bfloat16),
                w=torch.zeros(4, 6))
    args.update(change)
    return args


@pytest.mark.parametrize("args,error,match", [
    (_kernel_args(h=torch.zeros(10, 6)), TypeError, "bfloat16"),
    (_kernel_args(w=torch.zeros(4, 6, dtype=torch.bfloat16)), TypeError,
     "float32"),
    (_kernel_args(w=torch.zeros(3, 4, 6)), ValueError, "expected"),
    (_kernel_args(w=torch.zeros(4, 5)), ValueError, "expected"),
    (_kernel_args(h=torch.zeros(6, 10, dtype=torch.bfloat16).T),
     ValueError, "column stride"),
    (_kernel_args(w=torch.zeros(6, 4).T), ValueError, "column stride"),
    (_kernel_args(), ValueError, "CUDA device"),
], ids=["h-f32", "w-bf16", "w-3d", "k-mismatch", "h-strided-cols",
        "w-strided-cols", "cpu-tensors"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(args, error,
                                                              match):
    before = dict(agg.LAUNCHES)
    with pytest.raises(error, match=match):
        pt.pretransform_kernel(**args)
    assert agg.LAUNCHES == before


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(4)
    h = torch.from_numpy(rng.randn(70, 12).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(16, 12).astype(np.float32))
    before = dict(agg.LAUNCHES)
    assert torch.equal(pt.pretransform(h, w),
                       pt.pretransform_plain(h, pt.split_weight(w)))
    assert agg.LAUNCHES == before


# ------------------------------------------------- mean_pretransform's path

@pytest.fixture
def stub_wrapper(monkeypatch):
    """``layers.pretransform`` replaced by a CUDA-free stub that counts as
    the kernel's wrapper does and computes the plain version."""
    monkeypatch.setitem(agg.LAUNCHES, "pretransform", 0)

    def stub(h, w):
        agg.LAUNCHES["pretransform"] += 1
        return pt.pretransform_plain(h, pt.split_weight(w))

    monkeypatch.setattr(layers, "pretransform", stub)
    return agg.LAUNCHES


def _layer_inputs(dtype, seed=5):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(40, 12).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (8, 24)).astype(np.float32))
    return h, w


def _old_path(w, h):
    """The float32 path every other call keeps."""
    d = h.shape[1]
    w = torch.cat([w[:, :d], w[:, d:]]).float()
    return torch.matmul(h.float(), w.T).to(h.dtype)


def test_float32_table_keeps_the_float32_product(stub_wrapper):
    h, w = _layer_inputs(torch.float32)
    with torch.no_grad():
        got = layers.mean_pretransform(w, h)
    assert stub_wrapper["pretransform"] == 0
    assert torch.equal(got, _old_path(w, h))


@pytest.mark.parametrize("which", ["h", "w"])
def test_differentiated_call_keeps_the_float32_product(stub_wrapper, which):
    h, w = _layer_inputs(torch.bfloat16)
    (h if which == "h" else w).requires_grad_(True)
    got = layers.mean_pretransform(w, h)
    assert stub_wrapper["pretransform"] == 0
    assert got.requires_grad
    assert torch.equal(got.detach(), _old_path(w.detach(), h.detach()))
    got.float().sum().backward()
    assert (h if which == "h" else w).grad is not None


@pytest.mark.parametrize("gcn", [False, True])
def test_bf16_table_autograd_would_not_record_takes_the_wrapper(stub_wrapper,
                                                                gcn):
    h, w = _layer_inputs(torch.bfloat16)
    w = w[:, :12] if gcn else w
    z = layers.mean_pretransform(w, h, gcn=gcn)     # nothing requires grad
    assert stub_wrapper["pretransform"] == 1
    w.requires_grad_(True)
    with torch.no_grad():                           # grad mode off
        z2 = layers.mean_pretransform(w, h, gcn=gcn)
    assert stub_wrapper["pretransform"] == 2
    assert torch.equal(z, z2) and not z2.requires_grad
    assert z.shape == (40, 8 if gcn else 16)
