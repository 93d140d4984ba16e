"""The summation order of the packed GCN kernel (``csrc/gcn_packed.cu``),
emulated on the CPU and held to the Pallas kernel in interpret mode.

The kernel gives each adjacency row to one warp, which reads the row's bits
as little-endian 32-bit words and walks the set bits word by word, and in a
word from bit 0 up: bit t of word w is column (t % 8)·N/8 + 4w + t // 8 of
the group-64 layout.  For each set bit j it adds round(x[j]·n[j]) (rounded
to x's dtype) to f32 accumulators, then writes n[r]·acc + n²·real[r]·x[r].
``kernel_emulation`` does the same in torch, one walk position at a time
(adding a zero product leaves an f32 sum unchanged, so the loop over all N
positions sums the set bits in the kernel's order).  Held within 1e-5 of the
Pallas kernel (f32: atol = rtol = 1e-5; bf16 x: 1e-5 of the largest |y|, the
products with the 0/1 entries being exact), on molecule-like graphs, an
all-padding graph (only the universal self-loop, no real atom) and a graph
with a dense row (one atom bonded to every other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import druglamp_tpu.kernels.gcn_pallas as jgk
from druglamp_tpu_torch.data.encoding import pack_adjacency, unpack_bits
from druglamp_tpu_torch.kernels import gcn as pgk

N = 256                # the Pallas kernel's row tile; a multiple of the kernel's 64


def walk_order(n: int) -> torch.Tensor:
    """Column of each walk position: word w = p // 32, bit t = p % 32."""
    nb = n // 8
    p = torch.arange(n)
    w, t = p // 32, p % 32
    return (t % 8) * nb + 4 * w + t // 8


def kernel_emulation(packed, nrm, n2r, x) -> torch.Tensor:
    """y of the CUDA kernel, summed in its order, in f32 → (B, N, C)."""
    B, n, C = x.shape
    order = walk_order(n)
    bits = unpack_bits(packed)[:, :, order].float()          # (B, N, N) in walk order
    xs = (x.float() * nrm[..., None]).to(x.dtype).float()    # round(x·n) to x's dtype
    acc = torch.zeros(B, n, C)
    for p in range(n):
        acc = acc + bits[:, :, p, None] * xs[:, order[p]][:, None, :]
    return nrm[..., None] * acc + n2r[..., None] * x.float()


def _graphs():
    """Three graphs of N nodes: molecule-like (ragged atoms, bonds among
    them, the universal self-loop), all padding, and one whose atom 0 is
    bonded to every other atom."""
    r = np.random.RandomState(11)
    adj = np.zeros((3, N, N), np.uint8)
    ar = np.arange(N)
    n_atoms = np.array([70, 0, 200])
    for _ in range(3 * n_atoms[0]):
        i, j = r.randint(0, n_atoms[0], 2)
        adj[0, i, j] = adj[0, j, i] = 1
    adj[2, 0, : n_atoms[2]] = adj[2, : n_atoms[2], 0] = 1
    adj[:, ar, ar] = 1
    real = (ar[None, :] < n_atoms[:, None]).astype(np.float32)
    packed = pack_adjacency(adj)
    deg = adj.sum(-1).astype(np.float32) + real
    nrm = (1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32)
    return packed, nrm, (nrm * nrm * real).astype(np.float32), adj


def test_walk_order_visits_every_column_once():
    packed, _, _, adj = _graphs()
    order = walk_order(N)
    assert sorted(order.tolist()) == list(range(N))
    # bit p of the row's little-endian words is the column order[p]
    words = torch.from_numpy(packed[2, 0].copy()).view(torch.int32)
    bits = [(int(words[p // 32]) >> (p % 32)) & 1 for p in range(N)]
    np.testing.assert_array_equal(np.array(bits), adj[2, 0, order.numpy()])


@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_summation_order_matches_pallas(monkeypatch, dtype, C):
    monkeypatch.setattr(jgk, "INTERPRET", True)
    packed, nrm, n2r, _ = _graphs()
    x32 = np.random.RandomState(C).randn(3, N, C).astype(np.float32)
    ref = np.asarray(jgk.gcn_packed_matmul(jnp.asarray(packed), jnp.asarray(nrm),
                                           jnp.asarray(n2r), jnp.asarray(x32).astype(dtype)))
    x = torch.from_numpy(x32).to(getattr(torch, dtype))
    args = (torch.from_numpy(packed), torch.from_numpy(nrm), torch.from_numpy(n2r), x)
    got = kernel_emulation(*args).numpy()
    plain = pgk.gcn_packed_plain(*args).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()
    # the all-padding graph: each node its own single self-loop, y = round(x)
    np.testing.assert_array_equal(got[1], x[1].float().numpy())
