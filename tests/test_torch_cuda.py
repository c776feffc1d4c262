"""Tests of the port that need a CUDA device: each CUDA kernel against its
plain PyTorch version on the card (P1 and P3 also on segments long enough
to be split across a block), P1's backward against autograd through its plain
version, one PAGTN training step against the CPU, P4's forward (with its
statistics m and l) and backward kernels against the plain flash
attention (the float32 backward also against its formulas in float64),
the encoder's logits against the CPU, GraphConv's kernels K1 (neighbour
sum; also from R edge rows into N nodes, as MPNN's edge-id tables call
it), K2 (neighbour max and its backward) and K3 (graph max readout and
its backward) against their plain versions (K1, K2 and K3, forward and
backward, on both of their kernel paths, float4 rows and one float a
lane, bit for bit against the JAX package's slot-order arithmetic or
their plain versions; all of them at NaN, infinities, signed zeros and
values at and below NEG, signs of zeros compared, and P1 at +inf and NaN
logits), K4 (the neighbour-slot gather of GAT and AttentiveFP, forward and
its backward through K1) bit for bit against its plain versions on both
kernel paths, at degrees 0 to 10 and non-finite rows, one GraphConv
training step against the CPU, one step of GCN, GAT, AttentiveFP and
DMPNN against the CPU, GraphConv's streamed fit_on_device bit for bit
against its resident run, a learning-rate schedule on the card
against the CPU, P2 in bfloat16 bit for bit against its plain version
(each segment's edges added in CSR order, every add rounded), the COO
message passing (P2 forward and backward, K3 over edge destinations)
against the plain versions at ghost and non-finite rows, one step of
GNNModular (each task), InfoGraph, InfoGraph* and PNA against the CPU,
``segment_max`` of a ``[NaN, 1]`` segment, and one step of GraphConv,
GCN, GAT, AttentiveFP, MPNN and DMPNN switched to their COO branches
against the CPU, with their launches of P1, P2, P3 and K3; one step of
DAGModel against the CPU with its launches of P2 (12 level passes, 12 in
the backward) and P3, a DAG level pass (P2 both ways) against the plain
versions, one step of WeaveModel and DTNNModel against the CPU, one step
of CGCNNModel and MEGNetModel against the CPU with their launches of P2
and P3, and CGCNN's edge sum (P2) and MEGNet's edges-into-graphs sum (P3
over the node sums) against the plain versions; two fits of 2 steps from
one seed the same bits for each model whose backward had float atomics
(PNA, InfoMax3D pretraining, GNNModular's edge prediction and infomax,
DMPNN, DTNN, MPNN, MEGNet) and for MXMNet and AtomicConv; one step of
MXMNetModel and AtomicConvModel, one episode of SupportGraphClassifier
(siamese, attn, res) and EGNNLayer's forward and backward against the
CPU, with their launches of P2 and P3.
They skip where
there is no GPU.  This file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepchem_tpu_torch import (AttentiveFPModel, BertEncoderMLM,
                                ConvMolFeaturizer, DMPNNFeaturizer,
                                DMPNNModel, GATModel, GCNModel, GNNModular,
                                GraphConvModel, InfoGraphModel,
                                InfoGraphStarModel, MolGraphConvFeaturizer,
                                PagtnModel, PagtnMolGraphFeaturizer,
                                PNAModel)
from deepchem_tpu_torch.ops import (NEG, CooCsr, build_neighbor_table,
                                    build_rev_slot, dst_segment_max_sumgrad,
                                    dst_segment_sum, gather_neighbors_sum,
                                    graph_max_pool, nei_gather,
                                    nei_max_incl_self, nei_sum,
                                    nei_sum_edges, take_src)
from deepchem_tpu_torch.ops.nei_table import (_nei_max_backward,
                                              _nei_sum_forward,
                                              float4_launches,
                                              nei_gather_float4_launches,
                                              nei_max_backward_reference,
                                              nei_max_reference,
                                              nei_sum_reference)
from deepchem_tpu_torch.ops.segment import (
    _graph_max_backward, _graph_max_forward,
    graph_max_pool_backward_reference,
    graph_max_pool_float4_launches, graph_max_pool_reference)
from deepchem_tpu_torch.ops.csr_segment import (
    csr_neighbor_sum_reference, csr_segment_softmax,
    csr_segment_softmax_reference, csr_segment_sum,
    csr_segment_sum_reference, edges_to_csr, fused_gather_segment_sum)
from deepchem_tpu_torch.ops.flash_attention import (
    _forward_reference, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_reference)

# same f32 inputs, summed in another order
ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,H', [(64, 300, 4), (512, 6144, 1),
                                   (2048, 16384, 8), (7, 0, 1)])
def test_csr_segment_softmax_kernel_matches_plain_version(cuda, N, E, H):
    rng = np.random.RandomState(N + E + H)
    perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
    logits = torch.from_numpy(rng.randn(E, H).astype(np.float32)[perm])
    row_ptr = torch.from_numpy(row_ptr)
    before = csr_segment_softmax.launches
    y = csr_segment_softmax(logits.to(cuda), row_ptr.to(cuda))
    torch.cuda.synchronize()
    assert csr_segment_softmax.launches == before + (1 if E else 0)
    np.testing.assert_allclose(
        y.cpu().numpy(),
        csr_segment_softmax_reference(logits, row_ptr).numpy(), atol=ATOL)


# kSplitEdges in csrc/csr_segment_softmax.cu, csrc/csr_segment_sum.cu and
# csrc/fused_gather_segment_sum.cu: longer segments are split across the
# kernel's block of 8 warps
SPLIT_EDGES = 128


def _long_softmax_case(name):
    """``(lengths, H, fill)`` of a P1 case with long segments; ``fill``
    edits the logits of the case's longest segment."""
    def all_neg(x):
        x[:] = NEG

    def head_neg_inf(x):
        x[:, -1] = -np.inf
    short = list(np.random.RandomState(0).randint(0, 34, 300))
    return {'ghost_1536_H1': (short + [1536], 1, None),
            'ghost_1536_H4': (short + [1536], 4, None),
            'segment_5000_H1': ([3, 5000, 0, 7], 1, None),
            'split_edges_pm1_H1': ([SPLIT_EDGES - 1, SPLIT_EDGES,
                                    SPLIT_EDGES + 1, 2, SPLIT_EDGES + 1,
                                    0], 1, None),
            'split_edges_pm1_H4': ([SPLIT_EDGES + 1, SPLIT_EDGES, 0,
                                    SPLIT_EDGES - 1], 4, None),
            'all_neg_2000_H2': ([5, 2000, 9], 2, all_neg),
            'head_neg_inf_2000_H4': ([11, 2000, 0], 4, head_neg_inf),
            'segment_40000_H1': ([7] * 511 + [40000], 1, None)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ghost_1536_H1', 'ghost_1536_H4',
                                  'segment_5000_H1', 'split_edges_pm1_H1',
                                  'split_edges_pm1_H4', 'all_neg_2000_H2',
                                  'head_neg_inf_2000_H4', 'segment_40000_H1'])
def test_csr_segment_softmax_long_segments_match_plain_version(cuda, name):
    """Segments around the split threshold, a ghost-like segment of 1.5k
    edges among short ones, 5k and 40k edges, a long all-NEG segment
    (1/count) and a long one with a head all -inf (0): within 1e-6 of the
    plain version and bit for bit the same on a repeat.  The plain version
    runs in float64 here: in float32 it sums a segment's exponentials in
    one accumulator, and where one logit dominates a long segment its sum
    drops the small terms, 2e-6 to 5e-5 off on these cases, while the
    kernel sums by lanes and warps first."""
    lengths, H, fill = _long_softmax_case(name)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    logits = np.random.RandomState(len(lengths) + H).randn(
        int(row_ptr[-1]), H).astype(np.float32) * 5
    if fill is not None:
        longest = int(np.argmax(lengths))
        fill(logits[row_ptr[longest]:row_ptr[longest + 1]])
    logits, row_ptr = (torch.from_numpy(a).to(cuda) for a in (logits,
                                                               row_ptr))
    before = csr_segment_softmax.launches
    y = csr_segment_softmax(logits, row_ptr)
    again = csr_segment_softmax(logits, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_softmax.launches == before + 2
    assert torch.equal(y, again)              # no atomics: bit for bit
    np.testing.assert_allclose(
        y.cpu().numpy(),
        csr_segment_softmax_reference(logits.double(), row_ptr).cpu().numpy(),
        atol=ATOL)
    if fill is not None:
        longest = int(np.argmax(lengths))
        part = y[row_ptr[longest]:row_ptr[longest + 1]].cpu().numpy()
        if name.startswith('all_neg'):
            np.testing.assert_allclose(part, 1 / lengths[longest],
                                       atol=ATOL)
        else:
            assert np.all(part[:, -1] == 0)


@pytest.mark.cuda
def test_csr_segment_softmax_rejects_what_the_kernel_does_not_take(cuda):
    logits = torch.zeros(8, 2, device=cuda)
    row_ptr = torch.tensor([0, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        csr_segment_softmax(logits.double(), row_ptr)
    with pytest.raises(TypeError):
        csr_segment_softmax(logits, row_ptr.long())
    with pytest.raises(ValueError):
        csr_segment_softmax(logits.T, row_ptr)
    with pytest.raises(ValueError):
        csr_segment_softmax(logits, row_ptr.cpu())


def _close(out, ref):
    """Sums in another order: within 1e-5 of the largest magnitude."""
    ref = ref.cpu().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max(
                                   initial=0.0))))


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,F', [(512, 6144, 32), (512, 6144, 1),
                                   (64, 300, 37), (64, 300, 3),
                                   (2048, 16384, 512), (7, 0, 4)])
def test_csr_segment_sum_kernel_matches_plain_version(cuda, N, E, F):
    rng = np.random.RandomState(N + E + F)
    perm, row_ptr = edges_to_csr(rng.randint(0, N - 2, E), N)  # empty tail
    msgs = torch.from_numpy(rng.randn(E, F).astype(np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    before = csr_segment_sum.launches
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(out, again)            # no atomics: bit for bit
    _close(out, csr_segment_sum_reference(msgs, row_ptr))


@pytest.mark.cuda
@pytest.mark.parametrize('F', [32, 1, 37, 512])
def test_csr_segment_sum_long_segments_match_plain_version(cuda, F):
    """Segments around the split threshold, several long ones in one block,
    a ghost-like segment of 1.5k edges and one of 40k, each sum bit for
    bit the same on a repeat."""
    lengths = [0, 3, SPLIT_EDGES - 1, SPLIT_EDGES, SPLIT_EDGES + 1, 5,
               SPLIT_EDGES + 7, 2 * SPLIT_EDGES, 1, 0, 8 * SPLIT_EDGES + 3,
               1536, 2, 40000]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    rng = np.random.RandomState(F)
    msgs = torch.from_numpy(rng.randn(int(row_ptr[-1]), F).astype(
        np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    before = csr_segment_sum.launches
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(out, again)            # no atomics: bit for bit
    # in float32 the plain version's index_add_ sums the 40k segment in an
    # order that changes from run to run and drifts by about the tolerance
    _close(out.double(), csr_segment_sum_reference(msgs.double(), row_ptr))
    assert torch.all(out[[0, 9]] == 0)


@pytest.mark.cuda
def test_csr_segment_sum_unaligned_rows_and_a_short_row_ptr(cuda):
    """A view 4 bytes off 16-byte alignment takes the scalar path; edges
    past row_ptr[N] are ignored."""
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(rng.randn(200 * 8 + 1).astype(np.float32))
    msgs = flat.to(cuda)[1:].view(200, 8)
    row_ptr = torch.tensor([0, 50, 50, 51, 180], dtype=torch.int32,
                           device=cuda)
    _close(csr_segment_sum(msgs, row_ptr),
           csr_segment_sum_reference(msgs, row_ptr))


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,F', [(2048, 4096, 64), (8192, 16384, 256),
                                   (64, 300, 37), (64, 200, 5)])
def test_fused_gather_segment_sum_kernel_matches_plain_version(cuda, N, E,
                                                               F):
    rng = np.random.RandomState(N + E + F)
    perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
    h = torch.from_numpy(rng.rand(N, F).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.randint(0, N, E).astype(np.int32)[perm])
    src, row_ptr = src.to(cuda), torch.from_numpy(row_ptr).to(cuda)
    before = fused_gather_segment_sum.launches
    out = fused_gather_segment_sum(h, src, row_ptr)
    torch.cuda.synchronize()
    assert fused_gather_segment_sum.launches == before + 1
    assert torch.equal(out, fused_gather_segment_sum(h, src, row_ptr))
    _close(out, csr_neighbor_sum_reference(h, src, row_ptr))


@pytest.mark.cuda
@pytest.mark.parametrize('F,aligned', [(1, True), (37, True), (64, True),
                                       (75, True), (300, True), (512, True),
                                       (600, True), (200, False),
                                       (300, False), (512, False),
                                       (700, False)])
def test_fused_gather_segment_sum_long_segments_match_plain_version(
        cuda, F, aligned):
    """P2 (float32) at segments around its split threshold, several long
    ones in one block, empty ones, a ghost-like segment of 1536 edges from
    one row and one of 40k edges, with some src out of range (the kernel
    clamps them to [0, N_h)); aligned, or a view 4 bytes off 16-byte
    alignment (one float a lane): rows of up to 512 floats in one walk of
    src, wider ones (600, 700) in passes.  Each sum within 1e-5 of the float64
    plain version on the clamped src and bit for bit the same on a
    repeat."""
    S = SPLIT_EDGES
    lengths = [0, 3, S - 1, S, S + 1, 5, S + 7, 2 * S, 1, 0, 8 * S + 3, 2,
               0, 0, 1536, 2, 40000]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    E, Nh = int(row_ptr[-1]), 4096
    rng = np.random.RandomState(F)
    src = rng.randint(0, Nh, E).astype(np.int32)
    src[row_ptr[14]:row_ptr[15]] = Nh - 1       # the ghost-like segment
    src[::997] = Nh + 3                         # out of range: clamped
    src[5::1009] = -2
    flat = torch.from_numpy(rng.randn(Nh * F + 1).astype(np.float32)).to(
        cuda)
    h = (flat[:-1] if aligned else flat[1:]).view(Nh, F)
    src_d = torch.from_numpy(src).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    before = fused_gather_segment_sum.launches
    out = fused_gather_segment_sum(h, src_d, row_ptr)
    again = fused_gather_segment_sum(h, src_d, row_ptr)
    torch.cuda.synchronize()
    assert fused_gather_segment_sum.launches == before + 2
    assert torch.equal(out, again)            # no atomics: bit for bit
    _close(out.double(), csr_neighbor_sum_reference(
        h.double(), src_d.clamp(0, Nh - 1), row_ptr))
    assert torch.all(out[[0, 9, 12, 13]] == 0)


@pytest.mark.cuda
def test_softmax_backward_matches_plain_autograd(cuda):
    """The Function's gradient (kernel forward, P3 in the backward)
    against autograd through the plain version, on the card."""
    rng = np.random.RandomState(5)
    perm, row_ptr = edges_to_csr(rng.randint(0, 500, 6144), 512)
    logits = torch.from_numpy(rng.randn(6144, 1).astype(np.float32)[perm])
    w = torch.from_numpy(rng.randn(6144, 1).astype(np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    grads = []
    before = csr_segment_sum.launches
    for fn in (csr_segment_softmax, csr_segment_softmax_reference):
        x = logits.to(cuda).requires_grad_()
        (fn(x, row_ptr) * w).sum().backward()
        grads.append(x.grad)
    assert csr_segment_sum.launches == before + 1
    _close(*grads)


@pytest.mark.cuda
def test_training_step_gradients_match_the_cpu(cuda):
    """One step of a small dropout-free PAGTN on the card and on the CPU
    from the same seed: losses and every parameter's gradient agree."""
    X = PagtnMolGraphFeaturizer().featurize(
        ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1'])
    y = np.random.RandomState(0).randint(0, 2, (4, 3)).astype(np.float32)
    kw = dict(n_tasks=3, mode='classification', batch_size=4, num_layers=2,
              dropout=0.0, seed=1)
    models = [PagtnModel(device=d, **kw) for d in (cuda, 'cpu')]
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for name, p in models[0].module.named_parameters():
        # attn.bias: the softmax is shift invariant, its exact gradient is 0
        assert name.endswith('attn.bias') or p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   cpu[name].grad.numpy(), atol=1e-5,
                                   err_msg=name)


# P4, against the plain version in float32 from the same inputs: the
# forward within 1e-5 (float32) and 2e-2 (bfloat16: p and the output
# rounded), the gradients within 1e-4 and 5e-2, scaled by max(1, |ref|);
# the bfloat16 o and each bfloat16 gradient also within 7e-3 and 1e-2 of
# their own max |ref|, which sound kernels meet and a kernel with one fault
# does not (scripts/flash_controls.py)
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}
FLASH_FWD_RTOL = 7e-3
FLASH_GRAD_RTOL = 1e-2


def _flash_run(fn, q, k, v, w, cast):
    """Output and q, k, v gradients of ``fn`` under the loss sum(out * w)."""
    ts = [t.detach().clone().to(cast).requires_grad_() for t in (q, k, v)]
    out = fn(*ts, q.shape[-1] ** -0.5)
    (out.float() * w.float()).sum().backward()
    return [out.detach()] + [t.grad for t in ts]


# S 64 (under one 128-row block), 128, 200 and 1000 (ragged against 64
# and 128), 384 with D 32; B*H of 1.  The bf16 backward runs two consumer
# warpgroups (128 own rows) a block at every S: at S 64 the second owns no
# valid rows.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,H,S,D', [(2, 12, 128, 64), (1, 3, 200, 32),
                                     (1, 1, 64, 64), (2, 3, 200, 64),
                                     (1, 2, 1000, 64), (2, 2, 384, 32)])
def test_flash_attention_kernels_match_plain_version(cuda, dtype, B, H, S,
                                                     D):
    rng = np.random.RandomState(S + D)
    q, k, v, w = (torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
                  .to(cuda, dtype) for _ in range(4))
    counts = [fn.launches for fn in (flash_attention,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq)]
    outs = [_flash_run(flash_attention, q, k, v, w, dtype),
            _flash_run(flash_attention_reference, q, k, v, w, torch.float32)]
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_attention, flash_attention_bwd_dkv,
                                   flash_attention_bwd_dq)] \
        == [c + 1 for c in counts]
    for i, (a, ref) in enumerate(zip(*outs)):
        tol = FLASH_TOL[dtype][i > 0] * max(1.0, ref.abs().max().item())
        assert a.dtype == dtype
        err = (a.float() - ref).abs().max().item()
        assert err <= tol, i
        if dtype == torch.bfloat16:
            rtol = FLASH_GRAD_RTOL if i > 0 else FLASH_FWD_RTOL
            assert err <= rtol * ref.abs().max().item(), i
    # no atomics: the output and every gradient repeat bit for bit
    again = _flash_run(flash_attention, q, k, v, w, dtype)
    for i, (a, b) in enumerate(zip(outs[0], again)):
        assert torch.equal(a, b), i


# m and l of the forward against the plain version's, per row
STAT_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [1, 63, 64, 65, 129, 200])
def test_flash_forward_kernel_matches_plain_version(cuda, dtype, D, S):
    """The forward alone at S under, on and past a 64-key tile and a
    128-query block: o within FLASH_TOL (and, in bfloat16, FLASH_FWD_RTOL
    of its own max |ref|), m and l within 1e-5 of max(1, |ref|) row by
    row, one launch, a bit-identical repeat."""
    rng = np.random.RandomState(7 * S + D)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    scale = D ** -0.5
    before = flash_attention.launches
    o, m, l = flash_attention_forward(q, k, v, scale)
    again = flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    # in float32 from the same inputs, as the other P4 checks
    ref_o, ref_m, ref_l = _forward_reference(q.float(), k.float(),
                                             v.float(), scale)
    tol = FLASH_TOL[dtype][0] * max(1.0, ref_o.abs().max().item())
    assert o.dtype == dtype
    err = (o.float() - ref_o).abs().max().item()
    assert err <= tol
    if dtype == torch.bfloat16:
        assert err <= FLASH_FWD_RTOL * ref_o.abs().max().item()
    for a, ref in ((m, ref_m), (l, ref_l)):
        assert bool(((a - ref).abs()
                     <= STAT_RTOL * ref.abs().clamp_min(1.0)).all())
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [65, 128, 200, 512])
def test_flash_f32_forward_on_the_tensor_cores_matches_plain_version(cuda, S,
                                                                     D):
    """The float32 forward, 3xTF32 on the tensor cores: o within
    FLASH_TOL's 1e-5 of max(1, |ref|) and m and l within STAT_RTOL of
    max(1, |ref|) row by row, against the plain version in float32 (no
    TF32: that keeps about 11 bits), bit-identical on a repeat."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(3 * S + D)
    q, k, v = (torch.from_numpy(rng.randn(4, 3, S, D).astype(np.float32))
               .to(cuda) for _ in range(3))
    scale = D ** -0.5
    o, m, l = flash_attention_forward(q, k, v, scale)
    again = flash_attention_forward(q, k, v, scale)
    ref_o, ref_m, ref_l = _forward_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.dtype == m.dtype == l.dtype == torch.float32
    tol = FLASH_TOL[torch.float32][0] * max(1.0, ref_o.abs().max().item())
    assert (o - ref_o).abs().max().item() <= tol
    for a, ref in ((m, ref_m), (l, ref_l)):
        assert bool(((a - ref).abs()
                     <= STAT_RTOL * ref.abs().clamp_min(1.0)).all())
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)


def _flash_bwd64(q, k, v, do, m, l, di, scale):
    """The backward kernels' formulas in float64 from the same inputs and
    statistics: ``(dq, dk, dv)``."""
    q, k, v, do, m, l, di = (t.double() for t in (q, k, v, do, m, l, di))
    p = torch.exp(q @ k.transpose(-1, -2) * scale - m[..., None]) \
        / l[..., None]
    ds = (do @ v.transpose(-1, -2) - di[..., None]) * p * scale
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


# S under, on and past a 64-row tile and 128 rows, and several tiles
@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [1, 63, 64, 65, 129, 200, 512])
def test_flash_f32_backward_on_the_tensor_cores_matches_plain_version(
        cuda, S, D):
    """The float32 dK/dV and dQ kernels, 3xTF32 on the tensor cores, from
    the forward kernel's m and l: each gradient within FLASH_TOL's 1e-4 of
    max(1, |ref|) of the plain version in float32 and within 1e-5 of
    max(1, |g|) of the same formulas in float64, one launch each, and
    bit-identical on a repeat."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(5 * S + D)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
                   .to(cuda) for _ in range(4))
    scale = D ** -0.5
    o, m, l = flash_attention_forward(q, k, v, scale)
    di = (o * do).sum(-1)
    args = (q, k, v, do, m, l, di, scale)
    before = [fn.launches for fn in (flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq)]
    dk, dv = flash_attention_bwd_dkv(*args)
    dq = flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_attention_bwd_dkv,
                                   flash_attention_bwd_dq)] \
        == [c + 1 for c in before]
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(*args)
    ref_dq = flash_attention_bwd_dq_reference(*args)
    exact = _flash_bwd64(*args)
    for name, a, ref, ref64 in (('dq', dq, ref_dq, exact[0]),
                                ('dk', dk, ref_dk, exact[1]),
                                ('dv', dv, ref_dv, exact[2])):
        assert a.dtype == torch.float32
        tol = FLASH_TOL[torch.float32][1] * max(1.0, ref.abs().max().item())
        assert (a - ref).abs().max().item() <= tol, name
        tol64 = 1e-5 * max(1.0, ref64.abs().max().item())
        assert (a.double() - ref64).abs().max().item() <= tol64, name
    again = flash_attention_bwd_dkv(*args) + (flash_attention_bwd_dq(*args),)
    for a, b in zip((dk, dv, dq), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(TypeError):
        flash_attention(q, q, q.bfloat16(), 0.125)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous(), 0.125)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                        0.125)
    with pytest.raises(ValueError):
        flash_attention(q, q, q.cpu(), 0.125)


@pytest.mark.cuda
def test_encoder_logits_match_the_cpu(cuda):
    """A small float32 encoder from one seed on the card and on the CPU,
    with a padding mask: logits within 1e-4 (sums in another order)."""
    kw = dict(vocab_size=40, hidden=64, layers=2, heads=2, intermediate=128,
              max_positions=34, seed=3)
    ids = torch.from_numpy(np.random.RandomState(0).randint(4, 40, (4, 32)))
    mask = torch.ones(4, 32)
    mask[1, 20:] = 0
    out = []
    for device in (cuda, 'cpu'):
        model = BertEncoderMLM(device=device, **kw).eval()
        with torch.no_grad():
            out.append(model(ids.to(device), mask.to(device)).cpu())
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-4)


def _table(n=600, seed=0):
    """A random undirected graph of ``n`` nodes with degrees 0 to 10: node
    0 has ten neighbours and the last 4 none."""
    rng = np.random.RandomState(seed)
    deg = np.zeros(n, int)
    src, dst = [], []
    pairs = [(0, j) for j in range(1, 11)] + [
        tuple(sorted(rng.randint(0, n - 4, 2))) for _ in range(3 * n)]
    for a, b in dict.fromkeys(pairs):
        if a != b and deg[a] < 10 and deg[b] < 10:
            src += [a, b]
            dst += [b, a]
            deg[a] += 1
            deg[b] += 1
    table, mask = build_neighbor_table(np.array(src), np.array(dst), n)
    deg = mask.sum(1).astype(np.int8)
    assert deg.max() == 10 and deg.min() == 0
    return torch.from_numpy(table), torch.from_numpy(deg)


def _values(rng, n, F, kind):
    if kind == 'normal':
        return rng.randn(n, F).astype(np.float32)
    if kind == 'ties':      # 0..2, half zeros, as after a ReLU
        return np.maximum(rng.randint(-2, 3, (n, F)), 0).astype(np.float32)
    return np.zeros((n, F), np.float32)              # every max a tie


@pytest.mark.cuda
@pytest.mark.parametrize('F', [1, 32, 64, 75, 128])
def test_nei_sum_kernel_matches_plain_version(cuda, F):
    table, deg = _table()
    h = torch.from_numpy(np.random.RandomState(F).randn(
        len(table), F).astype(np.float32))
    x = h.to(cuda).requires_grad_()
    before = (nei_sum.launches, nei_sum.backward_launches)
    out = nei_sum(x, table.to(cuda), deg.to(cuda))
    again = nei_sum(x.detach(), table.to(cuda), deg.to(cuda))
    g = torch.ones_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (nei_sum.launches, nei_sum.backward_launches) == \
        (before[0] + 2, before[1] + 1)
    ref = nei_sum_reference(h, table, deg)
    _close(out.detach(), ref)
    assert torch.equal(out.detach(), again)
    # the backward is the same sum of the cotangent
    _close(x.grad, nei_sum_reference(g.cpu(), table, deg))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['normal', 'ties', 'all_ties'])
@pytest.mark.parametrize('F', [1, 32, 64, 75, 128])
def test_nei_max_kernels_match_plain_version(cuda, F, kind):
    rng = np.random.RandomState(F)
    table, deg = _table()
    h = torch.from_numpy(_values(rng, len(table), F, kind))
    g = torch.from_numpy(rng.randn(len(table), F).astype(np.float32))
    x = h.to(cuda).requires_grad_()
    out, winner = nei_max_incl_self(x, table.to(cuda), deg.to(cuda),
                                    return_winner=True)
    out.backward(g.to(cuda))
    ref, ref_winner = nei_max_reference(h, table, deg)
    assert torch.equal(out.detach().cpu(), ref)
    assert torch.equal(winner.cpu(), ref_winner)
    _close(x.grad, nei_max_backward_reference(g, table, deg, ref_winner))
    if kind == 'all_ties':
        assert torch.equal(winner.cpu(), torch.arange(
            len(table), dtype=torch.int32)[:, None].expand(-1, F))
    # bit-identical on a repeat
    x2 = h.to(cuda).requires_grad_()
    out2, winner2 = nei_max_incl_self(x2, table.to(cuda), deg.to(cuda),
                                      return_winner=True)
    out2.backward(g.to(cuda))
    assert torch.equal(winner2, winner) and torch.equal(x2.grad, x.grad)


def _padded_table(n, K, seed):
    """A table ``[n, K]`` with degrees 0 to K (node 0 has K, node n - 1
    none, so its whole row is pad) and random neighbours.  Returns the
    table for K2's kernels, whose pad entries point far out of range (they
    may read a pad entry but must never follow it), the plain version's
    with 0 there, and the degrees."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, K + 1, n).astype(np.int8)
    deg[0], deg[-1] = K, 0
    safe = rng.randint(0, n, (n, K)).astype(np.int32)
    pad = np.arange(K)[None, :] >= deg[:, None]
    safe[pad] = 0
    poisoned = np.where(pad, np.int32(2**30), safe).astype(np.int32)
    return (torch.from_numpy(poisoned), torch.from_numpy(safe),
            torch.from_numpy(deg))


def _spread_pads(table, deg, seed):
    """``table`` with its pad entries pointing at random rows: K1 reads and
    adds them (times 0), so they must lie in range."""
    t = table.numpy().copy()
    pad = np.arange(t.shape[1])[None, :] >= deg.numpy()[:, None]
    t[pad] = np.random.RandomState(seed).randint(0, len(t), pad.sum())
    return torch.from_numpy(t)


def _on_card(a, cuda, aligned):
    """``a`` on the card; not ``aligned``: ``chip_smoke.misaligned``'s
    contiguous copy 4 bytes past a 16-byte boundary."""
    t = torch.from_numpy(a).to(cuda)
    if aligned:
        return t
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import misaligned
    return misaligned(t)


def _slot_order(first, terms):
    """float32 ``first`` plus each of ``terms`` (value, where) in order,
    added only where it applies: the kernels' arithmetic, bit for bit."""
    acc = first.copy()
    for value, where in terms:
        acc = np.where(where, acc + value, acc).astype(np.float32)
    return acc


# (F, aligned, float4 path): float4 rows at F 4, 64 and 128; one float a
# lane at F 1, 75 and at F 64 off 16-byte alignment
KERNEL_PATHS = [(4, True, True), (64, True, True), (128, True, True),
                (1, True, False), (75, True, False), (64, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 10, 32])
@pytest.mark.parametrize('F,aligned,float4', KERNEL_PATHS)
def test_nei_sum_kernel_paths_match_plain_version(cuda, F, aligned, float4,
                                                  K):
    _, safe, deg = _padded_table(300, K, seed=F + K)
    table = _spread_pads(safe, deg, seed=F + K)
    rng = np.random.RandomState(F * K)
    a = rng.randn(len(table), F).astype(np.float32)
    a[rng.rand(*a.shape) < 0.2] = -0.0
    h = _on_card(a, cuda, aligned)
    before, before4 = nei_sum.launches, float4_launches()
    out = nei_sum(h, table.to(cuda), deg.to(cuda))
    again = nei_sum(h, table.to(cuda), deg.to(cuda))
    torch.cuda.synchronize()
    assert nei_sum.launches == before + 2
    assert float4_launches() == (before4[0] + 2 * float4, before4[1],
                                 before4[2])
    _close(out, nei_sum_reference(torch.from_numpy(a), table, deg))
    # from -0 (the JAX sum starts from its first term), the real slots,
    # then each pad slot's row times 0 (+-0 here)
    real = np.arange(K)[None, :] < deg.numpy()[:, None]
    want = _slot_order(np.full_like(a, -0.0), [
        (a[table[:, j].numpy()] * np.where(real[:, j:j + 1], 1, 0).astype(
            np.float32), np.ones((len(a), 1), bool)) for j in range(K)])
    assert np.array_equal(out.cpu().numpy().view(np.int32),
                          want.view(np.int32))
    assert torch.equal(out, again)


def _edge_table(n, rows, K, seed):
    """An edge-id table ``[n, K]`` over ``rows`` edge rows, degrees 0 to K
    (node 0 has K, node n - 1 none), real entries random rows and pad
    entries 0, as the packer leaves them; and the degrees."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, K + 1, n).astype(np.int8)
    deg[0], deg[-1] = K, 0
    table = rng.randint(0, rows, (n, K)).astype(np.int32)
    table[np.arange(K)[None, :] >= deg[:, None]] = 0
    return torch.from_numpy(table), torch.from_numpy(deg)


def _bits_equal(out, want):
    """NaN where NaN, and elsewhere the same float32 bits."""
    out, want = out.cpu().numpy(), np.asarray(want, np.float32)
    nan = np.isnan(want)
    return np.array_equal(np.isnan(out), nan) and np.array_equal(
        out[~nan].view(np.int32), want[~nan].view(np.int32))


# (F, aligned, float4 path) of MPNN's K1 (F 64 at node_dim 64), of
# GraphConv's first layer (F 75), of DMPNN's (F 300, 75 float4 units a row)
# and of GCN's first layer (F 30)
EDGE_PATHS = [(64, True, True), (64, False, False), (75, True, False),
              (300, True, True), (300, False, False), (30, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('n,rows', [(300, 700), (300, 120), (1, 5)])
@pytest.mark.parametrize('F,aligned,float4', EDGE_PATHS)
@pytest.mark.parametrize('values', ['normal', 'non_finite'])
def test_nei_sum_kernel_over_edge_tables_matches_plain_version(
        cuda, F, aligned, float4, n, rows, values):
    """K1 from R source rows into N others (R != N), as MPNN's
    ``nei_sum_edges`` and ``take_src``'s backward call it, on both kernel
    paths: bit for bit the JAX slot order (from -0, the real slots, each
    pad slot's row times 0), NaN where NaN."""
    table, deg = _edge_table(n, rows, 10, seed=F + rows)
    rng = np.random.RandomState(F * rows)
    a = rng.randn(rows, F).astype(np.float32)
    a[rng.rand(*a.shape) < 0.2] = -0.0
    if values == 'non_finite':
        a[0, :3] = (np.inf, -np.inf, np.nan)        # row 0: behind the pads
        a[rng.rand(rows) < 0.1, 3] = np.nan
        a[rng.rand(rows) < 0.1, 4] = -np.inf
    h = _on_card(a, cuda, aligned)
    before, before4 = nei_sum.launches, float4_launches()
    out = _nei_sum_forward(h, table.to(cuda), deg.to(cuda), nei_sum)
    again = _nei_sum_forward(h, table.to(cuda), deg.to(cuda), nei_sum)
    torch.cuda.synchronize()
    assert out.shape == (n, F)
    assert nei_sum.launches == before + 2
    assert float4_launches() == (before4[0] + 2 * float4, before4[1],
                                 before4[2])
    ref = nei_sum_reference(torch.from_numpy(a), table, deg)
    assert _bits_equal(out, ref.numpy())
    real = np.arange(10)[None, :] < deg.numpy()[:, None]
    with np.errstate(invalid='ignore'):
        want = _slot_order(np.full((n, F), -0.0, np.float32), [
            (a[table[:, j].numpy()] * real[:, j:j + 1].astype(np.float32),
             np.ones((n, 1), bool)) for j in range(10)])
    assert _bits_equal(out, want)
    assert _bits_equal(again, out.cpu().numpy())


@pytest.mark.cuda
def test_mpnn_edge_ops_launch_k1_and_match_plain_version(cuda):
    """``nei_sum_edges`` forward and ``take_src`` backward each launch K1
    once, and agree with the CPU's plain versions bit for bit; the other
    directions are gathers."""
    rng = np.random.RandomState(0)
    n, E, F = 200, 512, 64
    e_table, e_deg = _edge_table(n, E, 10, seed=1)
    o_table, o_deg = _edge_table(n, E, 10, seed=2)
    edst = torch.from_numpy(rng.randint(0, n, E).astype(np.int32))
    esrc = torch.from_numpy(rng.randint(0, n, E).astype(np.int32))
    emask = torch.from_numpy((rng.rand(E) < 0.9).astype(np.float32))
    h = torch.from_numpy(rng.randn(E, F).astype(np.float32))
    c = torch.from_numpy(rng.randn(n, F).astype(np.float32))
    g_n = torch.from_numpy(rng.randn(n, F).astype(np.float32))
    g_e = torch.from_numpy(rng.randn(E, F).astype(np.float32))
    results = []
    for dev in (cuda, 'cpu'):
        x = h.to(dev).requires_grad_()
        y = c.to(dev).requires_grad_()
        before = (nei_sum_edges.launches, take_src.backward_launches)
        out = nei_sum_edges(x, e_table.to(dev), e_deg.to(dev),
                            edst.to(dev), emask.to(dev))
        taken = take_src(y, esrc.to(dev), o_table.to(dev), o_deg.to(dev))
        ((out * g_n.to(dev)).sum() + (taken * g_e.to(dev)).sum()).backward()
        if dev != 'cpu':
            torch.cuda.synchronize()
            assert (nei_sum_edges.launches, take_src.backward_launches) \
                == (before[0] + 1, before[1] + 1)
        results.append([t.detach().cpu() for t in (out, x.grad, taken,
                                                   y.grad)])
    for a, b in zip(*results):
        assert _bits_equal(a, b.numpy())


# (C, aligned, float4 path) of K4: GAT's e_src (C 8 at 8 heads) and z (C
# 64), AttentiveFP's C 200; one float a lane at C 1 and 75 and at C 64 off
# 16-byte alignment
GATHER_PATHS = [(8, True, True), (64, True, True), (200, True, True),
                (1, True, False), (75, True, False), (64, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('values', ['normal', 'non_finite'])
@pytest.mark.parametrize('C,aligned,float4', GATHER_PATHS)
def test_nei_gather_kernel_matches_plain_version(cuda, C, aligned, float4,
                                                 values):
    """K4's forward and its backward (K1 over the reverse-slot rows) on
    the card against their plain versions on the CPU, bit for bit, NaN
    where NaN: degrees 0 to 10, signed zeros, and with ``non_finite`` a
    non-finite row 0 (behind every pad slot) and cotangents; each launched
    once a call, on the path the entry says, and bit-identical on a
    repeat."""
    table, deg = _table()
    mask = (np.arange(10)[None, :] < deg.numpy()[:, None]).astype(np.float32)
    rs = torch.from_numpy(build_rev_slot(table.numpy(), mask))
    rng = np.random.RandomState(C)
    n = len(table)
    a = rng.randn(n, C).astype(np.float32)
    a[rng.rand(*a.shape) < 0.2] = -0.0
    w = rng.randn(n, 10, C).astype(np.float32)
    w[rng.rand(*w.shape) < 0.2] = -0.0
    if values == 'non_finite':
        a[0, 0], a[0, -1] = np.inf, np.nan
        a[rng.rand(n) < 0.1, C // 2] = -np.inf
        w[0, 0, 0] = np.inf                   # the pad slots' cotangent
        w[rng.rand(n) < 0.1, 3, -1] = np.nan
    results = []
    for dev in (cuda, 'cpu'):
        on = (lambda t: _on_card(t, cuda, aligned)) if dev == cuda \
            else torch.from_numpy
        x = on(a).requires_grad_()
        g = on(w)
        args = (table.to(dev), rs.to(dev), deg.to(dev))
        before = (nei_gather.launches, nei_gather.backward_launches)
        out = nei_gather(x, *args)
        out.backward(g)
        if dev == cuda:
            before4 = nei_gather_float4_launches()
            again = nei_gather(x.detach(), *args)
            torch.cuda.synchronize()
            assert (nei_gather.launches, nei_gather.backward_launches) == \
                (before[0] + 2, before[1] + 1)
            assert nei_gather_float4_launches() == before4 + float4
            assert _bits_equal(again, out.detach().cpu().numpy())
        results.append((out.detach().cpu(), x.grad.cpu()))
    assert results[0][0].shape == (n, 10, C)
    for got, want in zip(*results):
        assert _bits_equal(got, want.numpy())


@pytest.mark.cuda
def test_nei_gather_keeps_trailing_dims_and_repeats_bit_identically(cuda):
    """GAT's z ``[N, H, O]`` through K4 into ``[N, K, H, O]``, its
    gradient, twice."""
    table, deg = _table()
    mask = (np.arange(10)[None, :] < deg.numpy()[:, None]).astype(np.float32)
    rs = torch.from_numpy(build_rev_slot(table.numpy(), mask)).to(cuda)
    table, deg = table.to(cuda), deg.to(cuda)
    z = torch.randn(len(table), 8, 8, device=cuda)
    g = torch.randn(len(table), 10, 8, 8, device=cuda)
    runs = []
    for _ in range(2):
        x = z.clone().requires_grad_()
        out = nei_gather(x, table, rs, deg)
        out.backward(g)
        runs.append((out.detach(), x.grad))
    assert runs[0][0].shape == (len(table), 10, 8, 8)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert _bits_equal(runs[0][0], nei_gather(z.cpu(), table.cpu(), rs.cpu(),
                                              deg.cpu()).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 10, 32])
@pytest.mark.parametrize('F,aligned,float4', KERNEL_PATHS)
def test_nei_max_forward_kernel_paths_match_plain_version(cuda, F, aligned,
                                                          float4, K):
    """Both paths of K2's forward against the plain version, the max bit
    for bit and the winners equal; the pad entries point out of range,
    which the forward reads only for the first pad slot and never
    follows."""
    table, safe, deg = _padded_table(300, K, seed=F + K)
    rng = np.random.RandomState(F * K + 1)
    for kind in ('normal', 'ties'):
        a = _values(rng, len(table), F, kind)
        a[rng.rand(*a.shape) < 0.2] = -0.0
        h = _on_card(a, cuda, aligned)
        before, before4 = nei_max_incl_self.launches, float4_launches()
        out, winner = nei_max_incl_self(h, table.to(cuda), deg.to(cuda),
                                        return_winner=True)
        again, again_w = nei_max_incl_self(h, table.to(cuda), deg.to(cuda),
                                           return_winner=True)
        torch.cuda.synchronize()
        assert nei_max_incl_self.launches == before + 2
        assert float4_launches() == (before4[0], before4[1],
                                     before4[2] + 2 * float4)
        ref, ref_w = nei_max_reference(torch.from_numpy(a), safe, deg)
        assert np.array_equal(out.cpu().numpy().view(np.int32),
                              ref.numpy().view(np.int32))
        assert torch.equal(winner.cpu(), ref_w)
        assert torch.equal(out, again) and torch.equal(winner, again_w)


@pytest.mark.cuda
@pytest.mark.parametrize('K', [1, 10, 32])
@pytest.mark.parametrize('F,aligned,float4', KERNEL_PATHS)
def test_nei_max_backward_kernel_paths_match_plain_version(cuda, F, aligned,
                                                           float4, K):
    table, safe, deg = _padded_table(300, K, seed=F + K)
    rng = np.random.RandomState(F * K)
    h = torch.from_numpy(_values(rng, len(table), F, 'ties'))
    _, winner = nei_max_reference(h, safe, deg)
    a = rng.randn(len(table), F).astype(np.float32)
    a[rng.rand(*a.shape) < 0.2] = -0.0
    g = _on_card(a, cuda, aligned)
    w = winner.to(cuda)
    before, before4 = nei_max_incl_self.backward_launches, float4_launches()
    grad = _nei_max_backward(g, table.to(cuda), deg.to(cuda), w)
    again = _nei_max_backward(g, table.to(cuda), deg.to(cuda), w)
    torch.cuda.synchronize()
    assert nei_max_incl_self.backward_launches == before + 2
    assert float4_launches() == (before4[0], before4[1] + 2 * float4,
                                 before4[2])
    _close(grad, nei_max_backward_reference(torch.from_numpy(a), safe, deg,
                                            winner))
    # the JAX sum: each of the K slots adds g[t] where it hits, else +0.0
    wn, m = winner.numpy(), np.arange(len(table))[:, None]
    every = np.ones((len(a), 1), bool)
    want = _slot_order(np.where(wn == m, a, np.float32(0)), [
        (np.where((j < deg.numpy())[:, None] & (wn[t] == m), a[t],
                  np.float32(0)), every)
        for j, t in enumerate(safe.numpy().T)])
    assert np.array_equal(grad.cpu().numpy().view(np.int32),
                          want.view(np.int32))
    assert torch.equal(grad, again)


def _pool_case(F, seed=0):
    """Graphs of 3, 5, 0, 1, 40, 0 and 17 rows and 2 empty slots, a ghost
    tail of 20 rows, one masked row; integer values, so maxima tie."""
    sizes = [3, 5, 0, 1, 40, 0, 17]
    rng = np.random.RandomState(seed)
    n = sum(sizes) + 20
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(sizes + [0, 0])]),
                           dtype=torch.int32)
    mask = (torch.arange(n) < sum(sizes)).float()
    mask[4] = 0.0
    x = torch.from_numpy(rng.randint(-3, 3, (n, F)).astype(np.float32))
    g = torch.from_numpy(rng.randn(len(row_ptr) - 1, F).astype(np.float32))
    return x, row_ptr, mask, g


@pytest.mark.cuda
@pytest.mark.parametrize('masked', [True, False])
@pytest.mark.parametrize('F', [1, 32, 64, 75, 128])
def test_graph_max_pool_kernels_match_plain_version(cuda, F, masked):
    x, row_ptr, mask, g = _pool_case(F)
    mask = mask if masked else None
    before = (graph_max_pool.launches, graph_max_pool.backward_launches)
    t = x.to(cuda).requires_grad_()
    out = graph_max_pool(t, row_ptr.to(cuda),
                         None if mask is None else mask.to(cuda))
    out.backward(g.to(cuda))
    torch.cuda.synchronize()
    assert (graph_max_pool.launches, graph_max_pool.backward_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, mx, den = graph_max_pool_reference(x, row_ptr, mask)
    _close(out.detach(), ref)
    assert not out[[2, 5, 7, 8]].any()                # empty graphs: 0
    _close(t.grad, graph_max_pool_backward_reference(g, x, row_ptr, mask,
                                                     mx, den))
    assert not t.grad[-20:].any()                    # the ghost rows
    t2 = x.to(cuda).requires_grad_()
    out2 = graph_max_pool(t2, row_ptr.to(cuda),
                          None if mask is None else mask.to(cuda))
    out2.backward(g.to(cuda))
    assert torch.equal(out2, out) and torch.equal(t2.grad, t.grad)


# (F, x aligned, float4 path) of K3's forward and backward: float4 rows at
# F 4, 64, 128 and 512 (4 units a lane); one float at F 1, 37, 75
# and at F 128 off 16-byte alignment
POOL_PATHS = [(4, True, True), (64, True, True), (128, True, True),
              (512, True, True), (1, True, False), (37, True, False),
              (75, True, False), (128, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['ties', 'normal', 'signed_zeros'])
@pytest.mark.parametrize('F,aligned,float4', POOL_PATHS)
def test_graph_max_pool_forward_kernel_paths_match_plain_version(
        cuda, F, aligned, float4, kind):
    """Both paths of K3's forward against the plain version: out bit for
    bit, mx and den equal, counted by the C entry."""
    x, row_ptr, mask, _ = _pool_case(F, seed=F)
    rng = np.random.RandomState(F + 1)
    if kind == 'normal':
        x = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    elif kind == 'signed_zeros':
        x = torch.from_numpy(np.where(rng.rand(*x.shape) < 0.5, -0.0,
                                      0.0).astype(np.float32))
    xc = _on_card(x.numpy(), cuda, aligned)
    before, before4 = graph_max_pool.launches, \
        graph_max_pool_float4_launches()
    out, mx, den = _graph_max_forward(xc, row_ptr.to(cuda), mask.to(cuda))
    again = _graph_max_forward(xc, row_ptr.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert graph_max_pool.launches == before + 2
    assert graph_max_pool_float4_launches() == (before4[0] + 2 * float4,
                                                before4[1])
    ref, ref_mx, ref_den = graph_max_pool_reference(x, row_ptr, mask)
    assert np.array_equal(out.cpu().numpy().view(np.int32),
                          ref.numpy().view(np.int32))
    assert torch.equal(mx.cpu(), ref_mx) and torch.equal(den.cpu(), ref_den)
    assert all(torch.equal(a, b) for a, b in zip((out, mx, den), again))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['ties', 'normal', 'signed_zeros'])
@pytest.mark.parametrize('F,aligned,float4', POOL_PATHS)
def test_graph_max_pool_backward_kernel_paths_match_plain_version(
        cuda, F, aligned, float4, kind):
    """Both paths of K3's backward against the plain version, bit for bit
    (each element is the one product t * sel), counted by the C entry; the
    cotangent holds -0 entries."""
    x, row_ptr, mask, g = _pool_case(F, seed=F)
    rng = np.random.RandomState(F + 2)
    if kind == 'normal':
        x = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    elif kind == 'signed_zeros':
        x = torch.from_numpy(np.where(rng.rand(*x.shape) < 0.5, -0.0,
                                      0.0).astype(np.float32))
    g[torch.from_numpy(rng.rand(*g.shape) < 0.2)] = -0.0
    _, mx, den = graph_max_pool_reference(x, row_ptr, mask)
    xc = _on_card(x.numpy(), cuda, aligned)
    args = (g.to(cuda), xc, row_ptr.to(cuda), mask.to(cuda), mx.to(cuda),
            den.to(cuda))
    before, before4 = graph_max_pool.backward_launches, \
        graph_max_pool_float4_launches()
    dx = _graph_max_backward(*args)
    again = _graph_max_backward(*args)
    torch.cuda.synchronize()
    assert graph_max_pool.backward_launches == before + 2
    assert graph_max_pool_float4_launches() == (before4[0],
                                                before4[1] + 2 * float4)
    ref = graph_max_pool_backward_reference(g, x, row_ptr, mask, mx, den)
    assert np.array_equal(dx.cpu().numpy().view(np.int32),
                          ref.numpy().view(np.int32))
    assert torch.equal(dx, again)


@pytest.mark.cuda
def test_kernels_match_plain_version_on_non_finite_values(cuda):
    """K1, K2 and K3, forward and backward, on both paths, at NaN,
    infinities, signed zeros and values at and below NEG, K1 also from
    edge rows through an edge-id table, and P1 at +inf, NaN, -inf and
    overflowing logits on its three paths, H 1 and 3 (chip_smoke's phase 3
    cases): equal to the plain versions, NaN where NaN, signs of zeros
    equal."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import non_finite_cases
    results = non_finite_cases(np.random.RandomState(0), cuda)
    assert len(results) == 14
    assert all(all(r['checks'].values()) for r in results)
    assert all(r['nan_outputs'] > 0 for r in results)


@pytest.mark.cuda
def test_graph_max_pool_gives_zero_below_half_neg(cuda):
    x, row_ptr, mask, _ = _pool_case(4)
    out = graph_max_pool(torch.full_like(x, NEG).to(cuda), row_ptr.to(cuda),
                         mask.to(cuda))
    assert not out.any()


@pytest.mark.cuda
def test_table_kernels_reject_what_they_do_not_take(cuda):
    table, deg = _table(40)
    h = torch.randn(40, 8, device=cuda)
    with pytest.raises(TypeError):
        nei_sum(h, table.to(cuda), deg.to(cuda).to(torch.int32))
    with pytest.raises(ValueError):
        nei_sum(h, table, deg)                       # table on the CPU
    with pytest.raises(ValueError):
        nei_max_incl_self(h[:, ::2], table.to(cuda), deg.to(cuda))
    with pytest.raises(TypeError):
        graph_max_pool(h, torch.tensor([0, 10, 40], device=cuda))


@pytest.mark.cuda
def test_graphconv_training_step_gradients_match_the_cpu(cuda):
    """One step of a small GraphConvModel on the card and on the CPU from
    the same seed: losses and every parameter's gradient agree."""
    X = ConvMolFeaturizer().featurize(
        ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1'])
    y = np.random.RandomState(0).randint(0, 2, (4, 3)).astype(np.float32)
    kw = dict(n_tasks=3, batch_size=4, graph_conv_layers=[16, 16],
              dense_layer_size=32, seed=1)
    models = [GraphConvModel(device=d, **kw) for d in (cuda, 'cpu')]
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for name, p in models[0].module.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   cpu[name].grad.numpy(), atol=1e-5,
                                   err_msg=name)


# each new model small, from one seed, on the card and on the CPU
NEW_MODELS = {
    'gcn': (GCNModel, dict(graph_conv_layers=[16, 16])),
    'gat': (GATModel, dict(graph_attention_layers=[8, 8],
                           n_attention_heads=2)),
    'attentivefp': (AttentiveFPModel, dict(graph_feat_size=16)),
    'dmpnn': (DMPNNModel, dict(enc_hidden=16, ffn_hidden=16, ffn_layers=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(NEW_MODELS))
def test_table_path_models_training_step_matches_the_cpu(cuda, name):
    """One step of a small GCN, GAT, AttentiveFP or DMPNN on the card and
    on the CPU from the same seed: losses within 1e-5 relative and every
    parameter's gradient within 1e-5 of max(1, |g|); the card launches K1
    (GCN, DMPNN) or K4 and K1 in its backward (GAT, AttentiveFP)."""
    smiles = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'C', 'C[C@H](N)C(=O)O']
    model, kw = NEW_MODELS[name]
    feat = DMPNNFeaturizer() if name == 'dmpnn' else MolGraphConvFeaturizer()
    X = feat.featurize(smiles)
    y = np.random.RandomState(0).randn(len(smiles), 2).astype(np.float32)
    models = [model(n_tasks=2, batch_size=len(smiles), seed=1, device=d,
                    **kw) for d in (cuda, 'cpu')]
    def counts():
        return (nei_sum.launches, nei_sum.backward_launches,
                nei_sum_edges.launches, nei_gather.launches,
                nei_gather.backward_launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    # GCN's first layer reads the atom features, which need no gradient
    assert [a - b for a, b in zip(counts(), before)] == {
        'gcn': [2, 1, 0, 0, 0], 'dmpnn': [0, 0, 3, 0, 0],
        'gat': [0, 0, 0, 4, 4], 'attentivefp': [0, 0, 0, 4, 4]}[name]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _graphconv_data(n):
    smiles = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'FC(F)(F)c1ccc(Cl)cc1Br']
    X = ConvMolFeaturizer().featurize(smiles)
    X = X[np.resize(np.arange(len(smiles)), n)]
    y = np.random.RandomState(0).randint(0, 2, (n, 3)).astype(np.float32)
    from deepchem_tpu_torch import NumpyDataset
    return NumpyDataset(X, y)


@pytest.mark.cuda
@pytest.mark.parametrize('chunk', [1, 2, 3])
def test_streaming_fit_on_device_equals_resident(cuda, chunk):
    """fit_on_device past device_data_budget (chunks of 1 to 3 batches
    through pinned buffers and a side stream) equals the resident run bit
    for bit: every epoch's loss and every parameter."""
    ds = _graphconv_data(28)                          # 7 batches of 4
    kw = dict(n_tasks=3, batch_size=4, graph_conv_layers=[16, 16],
              dense_layer_size=32, seed=1, device=cuda)
    resident, streamed = GraphConvModel(**kw), GraphConvModel(**kw)
    stack = streamed._host_stack(ds)
    per_batch = sum(a.nbytes for part in stack for a in part) // 7
    streamed.device_data_budget = 2 * chunk * per_batch + 1
    runs = []
    for model in (resident, streamed):
        out = []
        model.fit_on_device(ds, nb_epoch=3, seed=2, all_losses=out)
        runs.append(out)
    assert streamed._fit_cache['dev'] is None
    assert runs[0] == runs[1]
    for (name, a), b in zip(resident.module.state_dict().items(),
                            streamed.module.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_schedule_on_the_card_matches_the_cpu(cuda):
    """fit with an ExponentialDecay rate on the card and on the CPU from
    the same seed: the same rate each update, the count in the optimizer's
    state, losses within 1e-5 relative."""
    from deepchem_tpu_torch.models.optimizers import ExponentialDecay
    ds = _graphconv_data(12)
    sched = ExponentialDecay(0.002, 0.9, 2)
    kw = dict(n_tasks=3, batch_size=4, graph_conv_layers=[16, 16],
              dense_layer_size=32, seed=1, learning_rate=sched,
              log_frequency=1)
    rates = {}
    for d in (cuda, 'cpu'):
        model = GraphConvModel(device=d, **kw)
        seen = []
        out = []
        model.fit(ds, nb_epoch=2, checkpoint_interval=0, all_losses=out,
                  callbacks=lambda m, step: seen.append(
                      m._torch_optimizer.learning_rate()))
        rates[str(d)] = (seen, out, model._torch_optimizer.count)
    (seen_g, out_g, n_g), (seen_c, out_c, n_c) = rates.values()
    assert n_g == n_c == 6
    assert seen_g == seen_c == [sched(k) for k in range(1, 7)]
    np.testing.assert_allclose(out_g, out_c, rtol=1e-5)


# scripts/bench_pallas_csr.py:76-78, then the one-value-a-lane path, units
# of two values (F 30), then rows of 512 and 1024 values on small graphs (a
# lane holds 2 and 4 units of 8 values)
P2_BF16_SHAPES = [(2048, 4096, 64), (2048, 4096, 256), (8192, 16384, 256),
                  (8192, 16384, 512), (16384, 32768, 512), (64, 300, 37),
                  (64, 200, 5), (64, 300, 30), (256, 600, 512),
                  (128, 300, 1024)]
# (kind, nodes, edges or the long segment's edges, F): 'long', one segment
# longer than SPLIT_EDGES (summed by the block by columns) among short
# ones; 'tail', the last half of the nodes with no edges and edges past
# row_ptr[N]; 'non_finite', the values of
# test_torch_coo.py's non-finite test, with two long segments
P2_BF16_CASES = ([('bench', n, e, f) for n, e, f in P2_BF16_SHAPES]
                 + [('long', 512, 2000, 64), ('long', 512, 4096, 300),
                    ('tail', 256, 600, 64), ('non_finite', 512, 1000, 64),
                    ('non_finite', 512, 1000, 37)])
P2_BF16_SPECIAL = np.array([np.inf, -np.inf, np.nan, 1e-40, -1e-40, 0.0,
                            -0.0, 3.3e38, -3.3e38, 1.0, 256.0], np.float32)


def _p2_bf16_inputs(kind, N, E, F, rng):
    """(row_ptr, src, [h values as float32 arrays]) of one case."""
    if kind in ('bench', 'tail'):
        perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
        src = rng.randint(0, N, E).astype(np.int32)[perm]
        if kind == 'tail':
            row_ptr[N // 2:] = row_ptr[N // 2]
        return row_ptr, src, [rng.rand(N, F), rng.randn(N, F) * 100]
    deg = rng.randint(0, 4, N)
    deg[N // 3] = E
    if kind == 'non_finite':
        deg[-1] = 300
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.randint(0, N, int(row_ptr[-1])).astype(np.int32)
    if kind == 'long':
        return row_ptr, src, [rng.rand(N, F), rng.randn(N, F) * 100]
    pick = P2_BF16_SPECIAL[rng.randint(0, len(P2_BF16_SPECIAL), (N, F))]
    return row_ptr, src, [np.where(rng.rand(N, F) < 0.25, pick,
                                   rng.randn(N, F) * 100)]


@pytest.mark.cuda
@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('kind,N,E,F', P2_BF16_CASES)
def test_fused_gather_segment_sum_bf16_kernel_is_its_plain_version(
        cuda, kind, N, E, F, aligned):
    """P2 in bfloat16 adds each segment's edges in CSR order, rounding every
    add to bfloat16, as its plain version (and the JAX kernel) does: bit
    for bit and the same on a repeat, aligned or 2 bytes off, on uniform
    and signed inputs at the bench's shapes and at rows of 512 and 1024
    values (more than one unit a lane), on segments long enough to be
    summed by the block by columns (F 64 and 300), with an empty tail of
    nodes, and at ±inf, NaN, subnormals, ±0 and sums that overflow."""
    rng = np.random.RandomState(N + E + F)
    row_ptr, src, values = _p2_bf16_inputs(kind, N, E, F, rng)
    src = torch.from_numpy(src).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    for v in values:
        h = torch.from_numpy(v.astype(np.float32)).to(cuda).to(
            torch.bfloat16)
        if not aligned:
            flat = torch.empty(N * F + 1, dtype=torch.bfloat16, device=cuda)
            flat[1:] = h.reshape(-1)
            h = flat[1:].view(N, F)
        before = fused_gather_segment_sum.bf16_launches
        out = fused_gather_segment_sum(h, src, row_ptr)
        again = fused_gather_segment_sum(h, src, row_ptr)
        torch.cuda.synchronize()
        assert fused_gather_segment_sum.bf16_launches == before + 2
        assert out.dtype == torch.bfloat16
        ref = csr_neighbor_sum_reference(h, src, row_ptr)
        assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
        assert torch.equal(out.view(torch.int16), again.view(torch.int16))


def _coo_batch(cuda):
    """A packed COO batch of 6 molecules, on the card and on the CPU."""
    smiles = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'C', 'C[C@H](N)C(=O)O']
    batch = GNNModular(device='cpu', batch_size=6)._graph_inputs(
        MolGraphConvFeaturizer().featurize(smiles))
    return [[torch.from_numpy(a).to(d) for a in batch]
            for d in (cuda, 'cpu')]


def _same_values(a, b, atol=ATOL):
    """Within ``atol``, NaN where NaN, infinities equal."""
    a, b = a.detach().cpu(), b.detach().cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ~torch.isnan(a)
    np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('specials', [False, True])
def test_coo_ops_match_plain_version(cuda, specials):
    """``gather_neighbors_sum`` (P2 forward, its transpose backward, the
    ghost edges' term) and PNA's edge-destination sum (P2) and max (K3)
    on the card against the plain versions on the CPU, forward and
    gradient, with NaN, infinities and -0 in real and ghost rows."""
    ours, plain = _coo_batch(cuda)
    N, E = ours[0].shape[0], ours[1].shape[0]
    rng = np.random.RandomState(3)
    x = rng.randn(N, 64).astype(np.float32)
    msgs = rng.randn(E, 64).astype(np.float32)
    if specials:
        for a in (x, msgs):
            a[1, 0], a[2, 1], a[3, 2], a[4] = np.nan, np.inf, -np.inf, -0.0
            a[-1, :3] = np.nan, np.inf, -0.0
    g_nodes = rng.randn(N, 64).astype(np.float32)
    before = (fused_gather_segment_sum.launches,
              fused_gather_segment_sum.backward_launches,
              graph_max_pool.launches, graph_max_pool.backward_launches)
    results = []
    for batch in (ours, plain):
        dev = batch[0].device
        esrc, edst, emask = batch[1], batch[2], batch[5]
        csr = CooCsr(*batch[6:])
        t = torch.from_numpy(x).to(dev).requires_grad_()
        m = torch.from_numpy(msgs).to(dev).requires_grad_()
        g = torch.from_numpy(g_nodes).to(dev)
        outs = [gather_neighbors_sum(t, esrc, edst, emask, csr),
                dst_segment_sum(m * emask[:, None], edst, csr),
                dst_segment_max_sumgrad(m, emask, csr)]
        torch.autograd.backward(outs, [g] * 3)
        results.append(outs + [t.grad, m.grad])
    torch.cuda.synchronize()
    assert (fused_gather_segment_sum.launches - before[0],
            fused_gather_segment_sum.backward_launches - before[1],
            graph_max_pool.launches - before[2],
            graph_max_pool.backward_launches - before[3]) == (2, 1, 1, 1)
    for a, b in zip(*results):
        _same_values(a, b)


# each COO model small, from one seed, on the card and on the CPU
COO_MODELS = {
    **{f'gnn_{task}': (GNNModular, dict(task=task, emb_dim=16))
       for task in ('edge_pred', 'mask_nodes', 'infomax', 'regression',
                    'classification')},
    'infograph': (InfoGraphModel, dict(embedding_dim=16)),
    'infograph_star': (InfoGraphStarModel, dict(embedding_dim=16)),
    'pna': (PNAModel, dict(hidden_dim=16)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(COO_MODELS))
def test_coo_models_training_step_matches_the_cpu(cuda, name):
    """One step of a small GNNModular (each task), InfoGraph, InfoGraph* or
    PNA on the card and on the CPU from the same seed: losses within 1e-5
    relative and every parameter's gradient within 1e-5 of max(1, |g|);
    the card launches P2 three times a forward (GCN layers) and twice in
    the backward (edge prediction 4: its gathers of h by source and by
    destination add one each), or PNA's P2 6 and K3 6 and 6 in its
    backward, and P2 9 in its backward (each layer's gathers of h by
    source and destination and of the mean by destination)."""
    smiles = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'C', 'C[C@H](N)C(=O)O']
    model, kw = COO_MODELS[name]
    X = MolGraphConvFeaturizer().featurize(smiles)
    y = np.random.RandomState(0).randn(len(smiles), 1).astype(np.float32)
    if name == 'gnn_classification':
        y = (y > 0).astype(np.float32)
    models = [model(batch_size=len(smiles), seed=1, device=d, **kw)
              for d in (cuda, 'cpu')]

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                graph_max_pool.launches, graph_max_pool.backward_launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == (
        [6, 9, 6, 6] if name == 'pna' else
        [3, 4, 0, 0] if name == 'gnn_edge_pred' else [3, 2, 0, 0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.cuda
def test_segment_max_keeps_nan_on_the_card(cuda):
    """A segment ``[NaN, 1]`` gives ``empty_value`` on the card, as on the
    CPU and in the JAX package: ``scatter_reduce``'s ``amax`` drops the
    NaN there, and the NaNs are counted beside it."""
    from deepchem_tpu_torch.ops import segment_max, segment_softmax
    x = torch.tensor([float('nan'), 1.0, 2.0, -3.0, 5.0])
    ids = torch.tensor([0, 0, 1, 1, 3])
    out = segment_max(x.to(cuda), ids.to(cuda), 4)
    np.testing.assert_array_equal(out.cpu().numpy(), [0.0, 2.0, 0.0, 5.0])
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  segment_max(x, ids, 4).numpy())
    y = segment_softmax(x.to(cuda), ids.to(cuda), 4)
    assert torch.isnan(y[:2]).all() and torch.isfinite(y[2:]).all()


# the COO branches of the table-path models, small
BRANCH_MODELS = {
    'graphconv': (GraphConvModel, dict(graph_conv_layers=(16, 16),
                                       dense_layer_size=16,
                                       mode='regression')),
    'gcn': (GCNModel, dict(graph_conv_layers=(16, 16))),
    'gat': (GATModel, dict(graph_attention_layers=(8, 8),
                           n_attention_heads=2)),
    'attentivefp': (AttentiveFPModel, dict(graph_feat_size=16)),
    'mpnn': (None, dict(node_dim=16, T=2, M=2)),
    'dmpnn': (DMPNNModel, dict(enc_hidden=16, ffn_hidden=16)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(BRANCH_MODELS))
def test_coo_branches_training_step_matches_the_cpu(cuda, name):
    """One step of a small model with its class switched to the COO branch,
    on the card and on the CPU from the same seed: losses within 1e-5
    relative and every gradient within 1e-5 of max(1, |g|); the card
    launches P1, P2, P2's transpose, P3 and K3 (forward, backward) as
    chip_smoke.py's phase 17 counts them."""
    from deepchem_tpu_torch import MPNNModel
    smiles = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'C', 'C[C@H](N)C(=O)O']
    model, kw = BRANCH_MODELS[name]
    model = model or MPNNModel
    feat = {'graphconv': ConvMolFeaturizer(), 'dmpnn': DMPNNFeaturizer(),
            'mpnn': MolGraphConvFeaturizer(use_edges=True)}.get(
                name, MolGraphConvFeaturizer())
    X = feat.featurize(smiles)
    y = np.random.RandomState(0).randn(len(smiles), 2).astype(np.float32)
    flags = {'uses_edge_table': False} if name in ('mpnn', 'dmpnn') else \
        {'uses_neighbor_table': False, 'uses_rev_slot': False}
    own = {k: model.__dict__[k] for k in flags if k in model.__dict__}

    def counts():
        return (csr_segment_softmax.launches,
                fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches, graph_max_pool.launches,
                graph_max_pool.backward_launches)
    try:
        for k, v in flags.items():
            setattr(model, k, v)
        models = [model(n_tasks=2, batch_size=len(smiles), seed=1, device=d,
                        **kw) for d in (cuda, 'cpu')]
        before = counts()
        losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
        torch.cuda.synchronize()
    finally:
        for k in flags:
            if k in own:
                setattr(model, k, own[k])
            else:
                delattr(model, k)
    assert [a - b for a, b in zip(counts(), before)] == {
        'graphconv': [0, 2, 3, 1, 3, 3], 'gcn': [0, 2, 1, 2, 0, 0],
        'gat': [2, 2, 6, 4, 0, 0], 'attentivefp': [2, 2, 6, 3, 0, 0],
        'mpnn': [2, 2, 2, 6, 0, 0], 'dmpnn': [0, 3, 2, 1, 0, 0]}[name]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


DAG_SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
              'C', 'C[C@H](N)C(=O)O', 'CCCCCCCCCCCCCCN']


def _dag_graphs():
    from deepchem_tpu_torch import DAGTransformer
    X = ConvMolFeaturizer().featurize(DAG_SMILES)
    return DAGTransformer(max_atoms=50).transform_array(X, None, None,
                                                        None)[0]


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['regression', 'classification'])
def test_dag_training_step_matches_the_cpu(cuda, mode):
    """One step of a small DAGModel on the card and on the CPU from the
    same seed: losses within 1e-5 relative and every gradient within 1e-5
    of max(1, |g|); the card launches P2 once a level pass (12) and 12
    times in the backward (each pass's source gather), P3 once."""
    from deepchem_tpu_torch import DAGModel
    X = _dag_graphs()
    y = np.random.RandomState(0).randn(len(X), 2).astype(np.float32)
    if mode == 'classification':
        y = (y > 0).astype(np.float32)
    models = [DAGModel(n_tasks=2, mode=mode, n_graph_feat=16,
                       batch_size=len(X), seed=1, device=d)
              for d in (cuda, 'cpu')]

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [12, 12, 1]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.cuda
@pytest.mark.parametrize('F', [30, 7])
def test_dag_level_pass_matches_plain_version(cuda, F):
    """A level pass's sum of selected messages, ``dst_segment_sum`` of
    ``gather_src(h) * sel`` over a packed DAG batch (ghost edges
    included), and its gradient: the card's P2 both ways against the CPU's
    plain versions within 1e-5 of max(1, |ref|); F 30 takes float4 rows,
    F 7 one float a lane."""
    from deepchem_tpu_torch import DAGModel
    from deepchem_tpu_torch.ops import N_CSR, gather_src
    model = DAGModel(n_tasks=1, batch_size=8, device='cpu')
    arrays = model._graph_inputs(_dag_graphs())
    rng = np.random.RandomState(F)
    _, esrc, edst, _, _, emask = arrays[:6]
    depth = arrays[6 + N_CSR]
    sel = ((depth[edst] == 1) & (depth[esrc] == 2)).astype(np.float32) \
        * emask
    assert sel.sum() > 0
    h = rng.randn(len(depth), F).astype(np.float32)
    g = rng.randn(len(depth), F).astype(np.float32)
    results = []
    for dev in (cuda, torch.device('cpu')):
        t = [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]
        csr = CooCsr(*t[6:6 + N_CSR])
        x = torch.from_numpy(h).to(dev).requires_grad_()
        msgs = gather_src(x, t[1], csr) \
            * torch.from_numpy(sel).to(dev)[:, None]
        out = dst_segment_sum(msgs, t[2], csr)
        out.backward(torch.from_numpy(g).to(dev))
        results.append((out.detach().cpu(), x.grad.cpu()))
    for a, b in zip(*results):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(),
            atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['weave', 'dtnn'])
def test_dense_grid_models_training_step_matches_the_cpu(cuda, name):
    """One step of a small WeaveModel or DTNNModel on the card and on the
    CPU from the same seed: losses within 1e-5 relative, every gradient
    within 1e-5 of max(1, |g|); Weave launches no kernel of the port's,
    DTNN P2 once in its backward (the embedding's rows summed by atomic
    number)."""
    from deepchem_tpu_torch import (CoulombMatrix, DTNNModel,
                                    WeaveFeaturizer, WeaveModel)
    from deepchem_tpu_torch.chem import mol_from_smiles
    from deepchem_tpu_torch.utils.conformers import ConformerGenerator
    if name == 'weave':
        X = WeaveFeaturizer().featurize(DAG_SMILES)
        y = np.random.RandomState(0).randint(0, 2, (len(X), 2)).astype(
            np.float32)

        def make(d):
            return WeaveModel(n_tasks=2, n_hidden=16, n_graph_feat=24,
                              batch_size=len(X), seed=1, device=d)
    else:
        gen = ConformerGenerator(seed=0)
        X = CoulombMatrix(max_atoms=23).featurize(
            [gen.generate_conformers(mol_from_smiles(s)) for s in DAG_SMILES])
        y = np.random.RandomState(0).randn(len(X), 1).astype(np.float32)

        def make(d):
            return DTNNModel(n_tasks=1, batch_size=len(X), seed=1, device=d)
    models = [make(d) for d in (cuda, 'cpu')]

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == (
        [0, 1, 0] if name == 'dtnn' else [0, 0, 0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _crystals():
    """Rock-salt NaCl (8 atoms), CsCl, bcc Fe and SrTiO3, and two random
    cells, as structure dicts."""
    fcc = [(0, 0, 0), (0, .5, .5), (.5, 0, .5), (.5, .5, 0)]
    cells = [(5.64, ['Na'] * 4 + ['Cl'] * 4, fcc + [
                  (.5, 0, 0), (0, .5, 0), (0, 0, .5), (.5, .5, .5)]),
             (4.12, ['Cs', 'Cl'], [(0, 0, 0), (.5, .5, .5)]),
             (2.87, ['Fe', 'Fe'], [(0, 0, 0), (.5, .5, .5)]),
             (3.905, ['Sr', 'Ti', 'O', 'O', 'O'], [
                 (0, 0, 0), (.5, .5, .5), (.5, .5, 0), (.5, 0, .5),
                 (0, .5, .5)])]
    out = [{'lattice': np.eye(3) * a, 'species': sp, 'frac_coords': fr}
           for a, sp, fr in cells]
    rng = np.random.RandomState(0)
    out += [{'lattice': np.eye(3) * 4.5, 'frac_coords': rng.rand(n, 3),
             'species': ['Mg', 'O', 'Na'][:n]} for n in (2, 3)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['cgcnn', 'megnet'])
def test_materials_training_step_matches_the_cpu(cuda, name):
    """One step of a small CGCNNModel or MEGNetModel on CGCNNFeaturizer
    graphs, on the card and on the CPU from the same seed: losses within
    1e-5 relative and every gradient within 1e-5 of max(1, |g|); CGCNN
    launches P2 once a convolution and twice in its backward, P3 twice;
    MEGNet P2 into the nodes once a block and twice in its backward, P3
    three times a block (the graph mean of h, the edges into the graphs)
    and twice for the readout, and from the second block, whose state u
    needs a gradient, P2 and P3 once more in the backward (u by each
    edge's destination, by each node's graph)."""
    from deepchem_tpu_torch import CGCNNFeaturizer, CGCNNModel, MEGNetModel
    X = CGCNNFeaturizer().featurize(_crystals())
    y = np.random.RandomState(0).randn(len(X), 1).astype(np.float32)
    if name == 'cgcnn':
        models = [CGCNNModel(atom_fea_len=16, n_conv=2, h_fea_len=24,
                             batch_size=len(X), seed=1, device=d)
                  for d in (cuda, 'cpu')]
        want = [2, 4, 2]
    else:
        models = [MEGNetModel(dim=16, n_blocks=2, batch_size=len(X), seed=1,
                              device=d) for d in (cuda, 'cpu')]
        want = [2, 5, 9]

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == want
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.cuda
@pytest.mark.parametrize('F', [64, 7])
def test_materials_edge_sums_match_plain_version(cuda, F):
    """CGCNN's sum of edge rows into their destinations
    (``dst_segment_sum``, P2 over the CSR by destination) and MEGNet's sum
    of edge rows into their graphs (P3 over those node sums by graph) over
    a packed crystal batch, ghost edges included, and their gradients:
    the card against the CPU's plain versions within 1e-5 of max(1,
    |ref|), one P2 and one P3 launch; F 64 takes float4 rows, F 7 one
    float a lane."""
    from deepchem_tpu_torch import CGCNNFeaturizer, CGCNNModel
    from deepchem_tpu_torch.ops import N_CSR, csr_row_ptr
    X = CGCNNFeaturizer().featurize(_crystals())
    arrays = CGCNNModel(batch_size=8, device='cpu')._graph_inputs(X)
    rng = np.random.RandomState(F)
    N, E = len(arrays[0]), len(arrays[1])
    e = rng.randn(E, F).astype(np.float32) * arrays[5][:, None]
    g_nodes = rng.randn(N, F).astype(np.float32)
    g_graphs = rng.randn(8 + 1, F).astype(np.float32)
    results = []
    for dev in (cuda, torch.device('cpu')):
        t = [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]
        csr = CooCsr(*t[6:6 + N_CSR])
        x = torch.from_numpy(e).to(dev).requires_grad_()
        before = (fused_gather_segment_sum.launches,
                  csr_segment_sum.launches)
        nodes = dst_segment_sum(x, t[2].long(), csr)
        graphs = csr_segment_sum(nodes, csr_row_ptr(t[3], 8 + 1))
        if dev.type == 'cuda':
            assert (fused_gather_segment_sum.launches,
                    csr_segment_sum.launches) == (before[0] + 1,
                                                  before[1] + 1)
        torch.autograd.backward([nodes, graphs],
                                [torch.from_numpy(g_nodes).to(dev),
                                 torch.from_numpy(g_graphs).to(dev)])
        results.append((nodes.detach().cpu(), graphs.detach().cpu(),
                        x.grad.cpu()))
    assert results[0][1].shape == (9, F)
    for a, b in zip(*results):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(),
            atol=1e-5 * max(1.0, float(b.abs().max())))


REPRO_SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
                'C[C@H](N)C(=O)O', 'c1ccsc1', 'FC(F)(F)c1ccc(Cl)cc1Br',
                'CC#N', 'C1CCCCC1', 'C[N+](C)(C)CC(=O)[O-]', 'OCC(O)CO',
                'CCCCCCCC']


def _complexes(n, seed=0):
    """``n`` small complexes as (coordinates, atomic numbers) pairs: a
    ligand of 6-8 atoms in a pocket of 14-19."""
    from deepchem_tpu_torch import AtomicConvFeaturizer
    rng = np.random.RandomState(seed)
    z = np.array([6, 7, 8, 16, 6, 6, 30, 53])

    def frag(k, spread):
        return ((rng.rand(k, 3) * spread).astype(np.float32),
                z[rng.randint(0, len(z), k)])
    return AtomicConvFeaturizer(
        frag1_num_atoms=8, frag2_num_atoms=20, complex_num_atoms=28,
        max_num_neighbors=4).featurize(
            [(frag(rng.randint(6, 9), 4.0), frag(rng.randint(14, 20), 8.0))
             for _ in range(n)])


ATOMIC_SMALL = dict(frag1_num_atoms=8, frag2_num_atoms=20,
                    complex_num_atoms=28, max_num_neighbors=4,
                    layer_sizes=(8, 4))


def _repro_case(name):
    """(make(device, seed), X, y) of a small model, batches of 6."""
    from deepchem_tpu_torch import (AtomicConvModel, CGCNNFeaturizer,
                                    CoulombMatrix, DTNNModel,
                                    InfoMax3DModular, MEGNetModel, MPNNModel,
                                    MXMNetFeaturizer, MXMNetModel,
                                    RDKitConformerFeaturizer)
    from deepchem_tpu_torch.chem import mol_from_smiles
    from deepchem_tpu_torch.utils.conformers import ConformerGenerator
    y = np.random.RandomState(0).randn(12, 1).astype(np.float32)
    if name == 'atomic_conv':
        return (lambda d, s: AtomicConvModel(batch_size=6, seed=s, device=d,
                                             **ATOMIC_SMALL),
                _complexes(12), y)
    if name == 'megnet':
        X = CGCNNFeaturizer().featurize(_crystals() * 2)
        return (lambda d, s: MEGNetModel(dim=16, n_blocks=2, batch_size=6,
                                         seed=s, device=d), X, y)
    if name == 'dtnn':
        gen = ConformerGenerator(seed=0)
        X = CoulombMatrix(max_atoms=23).featurize(
            [gen.generate_conformers(mol_from_smiles(s))
             for s in REPRO_SMILES])
        return (lambda d, s: DTNNModel(n_tasks=1, batch_size=6, seed=s,
                                       device=d), X, y)
    feat, make = {
        'pna': (MolGraphConvFeaturizer(), lambda d, s: PNAModel(
            hidden_dim=16, batch_size=6, seed=s, device=d)),
        'gnn_edge_pred': (MolGraphConvFeaturizer(), lambda d, s: GNNModular(
            task='edge_pred', emb_dim=16, batch_size=6, seed=s, device=d)),
        'gnn_infomax': (MolGraphConvFeaturizer(), lambda d, s: GNNModular(
            task='infomax', emb_dim=16, batch_size=6, seed=s, device=d)),
        'dmpnn': (DMPNNFeaturizer(), lambda d, s: DMPNNModel(
            n_tasks=1, enc_hidden=16, ffn_hidden=16, batch_size=6, seed=s,
            device=d)),
        'mpnn': (MolGraphConvFeaturizer(use_edges=True),
                 lambda d, s: MPNNModel(n_tasks=1, node_dim=16, T=2, M=2,
                                        batch_size=6, seed=s, device=d)),
        'infomax3d_pretrain': (RDKitConformerFeaturizer(),
                               lambda d, s: InfoMax3DModular(
                                   hidden_dim=16, num_layers=2,
                                   batch_size=6, seed=s, device=d)),
        'mxmnet': (MXMNetFeaturizer(), lambda d, s: MXMNetModel(
            dim=16, n_layers=2, batch_size=6, seed=s, device=d))}[name]
    return make, feat.featurize(REPRO_SMILES), y


REPRO_MODELS = ['atomic_conv', 'dmpnn', 'dtnn', 'gnn_edge_pred',
                'gnn_infomax', 'infomax3d_pretrain', 'megnet', 'mpnn',
                'mxmnet', 'pna']


@pytest.mark.cuda
@pytest.mark.parametrize('name', REPRO_MODELS)
def test_training_is_bit_reproducible_on_the_card(cuda, name):
    """Two fits of 2 steps from one seed on the card: every gradient after
    each step and every weight after the last the same bits.  The models
    whose backward held an ``index_add_`` with float atomics (PNA and
    InfoMax3D's gathers by an edge's end, GNNModular's loss gathers,
    DMPNN's gather by source, DTNN's embedding, MPNN's set2set query
    gather, MEGNet's state gathers) have a fixed-order one: P2, P3 or
    K1."""
    from deepchem_tpu_torch import NumpyDataset
    make, X, y = _repro_case(name)
    runs = []
    for _ in range(2):
        model = make(cuda, 0)
        grads = []
        model.fit(NumpyDataset(X, y), nb_epoch=1, checkpoint_interval=0,
                  deterministic=True, callbacks=lambda m, step: grads.append(
                      {n: p.grad.detach().clone()
                       for n, p in m.module.named_parameters()
                       if p.grad is not None}))
        runs.append((grads, {n: p.detach().clone()
                             for n, p in model.module.named_parameters()}))
    assert len(runs[0][0]) == len(runs[1][0]) == 2
    for a, b in zip(runs[0][0] + [runs[0][1]], runs[1][0] + [runs[1][1]]):
        assert set(a) == set(b)
        for n, t in a.items():
            assert torch.equal(t.view(torch.int32),
                               b[n].view(torch.int32)), n


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['mxmnet', 'atomic_conv'])
def test_slice_21_models_training_step_matches_the_cpu(cuda, name):
    """One step of a small MXMNetModel or AtomicConvModel on the card and
    on the CPU from the same seed: losses within 1e-5 relative and every
    gradient within 1e-5 of max(1, |g|), predictions within 1e-4;
    MXMNet launches P2 once a plex (2 a layer) and twice in each plex's
    backward, P3 once; AtomicConv none of the port's kernels."""
    make, X, y = _repro_case(name)
    X, y = X[:6], y[:6]
    models = [make(d, 1) for d in (cuda, 'cpu')]

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches)
    before = counts()
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == (
        [4, 8, 1] if name == 'mxmnet' else [0, 0, 0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for key, p in models[0].module.named_parameters():
        ref = cpu[key].grad.numpy()
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), ref, err_msg=key,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    preds = [m.predict_on_batch(X) for m in models]
    assert np.isfinite(preds[0]).all()
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['siamese', 'attn', 'res'])
def test_few_shot_episode_matches_the_cpu(cuda, kind):
    """One episode of a small SupportGraphClassifier on the card and on the
    CPU from the same weights: probabilities within 1e-5, the loss within
    1e-5 relative, every gradient within 1e-5 of max(1, |g|); P2 twice an
    encoding (support and queries) and once more in its backward, P3
    twice an encoding; two runs the same bits."""
    from deepchem_tpu_torch import NumpyDataset, SupportGraphClassifier
    from deepchem_tpu_torch.data import EpisodeGenerator
    X = MolGraphConvFeaturizer().featurize(REPRO_SMILES)
    y = (np.random.RandomState(1).rand(len(X), 2) < 0.4).astype(np.float32)
    y[:2] = [[1, 1], [0, 0]]
    ds = NumpyDataset(X, y)
    kw = dict(model=kind, n_pos=1, n_neg=3, n_test=4, n_feat=8,
              layer_sizes=(8, 8), max_depth=2)
    models = [SupportGraphClassifier(device=d, **kw) for d in (cuda, 'cpu')]
    _, support, batch = next(EpisodeGenerator(ds, 1, 3, 4, 1,
                                              np.random.RandomState(2)))
    packed = None
    for m in models:
        m._caps = m._dataset_caps(ds)
        packed = m._pack_episode(support, batch)
        m._build(m._to_device(packed))
    models[1].module.load_state_dict(
        {k: v.cpu() for k, v in models[0].module.state_dict().items()})

    def counts():
        return (fused_gather_segment_sum.launches,
                fused_gather_segment_sum.backward_launches,
                csr_segment_sum.launches)
    results = []
    for i, m in enumerate(models + models[:1]):
        ep = m._to_device(packed)
        m.module.zero_grad()
        before = counts()
        p = m.module(*ep[:3])
        loss = m.loss(p, *ep[3:])
        loss.backward()
        torch.cuda.synchronize()
        if i == 0:
            assert [a - b for a, b in zip(counts(), before)] == [4, 2, 4]
        results.append((p.detach().cpu(), loss.item(),
                        {n: q.grad.detach().cpu()
                         for n, q in m.module.named_parameters()}))
    (p0, l0, g0), (p1, l1, g1), (p2, l2, g2) = results
    np.testing.assert_allclose(p0.numpy(), p1.numpy(), atol=1e-5)
    np.testing.assert_allclose(l0, l1, rtol=1e-5)
    for key, ref in g1.items():
        np.testing.assert_allclose(
            g0[key].numpy(), ref.numpy(), err_msg=key,
            atol=1e-5 * max(1.0, float(ref.abs().max())))
        assert torch.equal(g0[key].view(torch.int32),
                           g2[key].view(torch.int32)), key
    assert torch.equal(p0, p2) and l0 == l2


@pytest.mark.cuda
def test_egnn_layer_matches_the_cpu(cuda):
    """EGNNLayer (hidden 16, coordinates updated, binned lengths as edge
    inputs) on a batch of conformer graphs: outputs and the gradients of
    h, x, the edge inputs and every weight within 1e-5 of max(1, |ref|)
    of the CPU's; P2 3 forward and 4 in the backward; a repeat the same
    bits."""
    from deepchem_tpu_torch import EquivariantGraphFeaturizer
    from deepchem_tpu_torch.feat import BatchGraphData
    from deepchem_tpu_torch.models import EGNNLayer
    from deepchem_tpu_torch.ops import coo_csr
    graphs = EquivariantGraphFeaturizer().featurize(REPRO_SMILES)
    batch = BatchGraphData(list(graphs))
    d = batch.pad(128, 256, num_graphs=len(graphs))
    ef = np.zeros((256, 5), np.float32)
    ef[:batch.num_edges] = np.concatenate([g.edge_weights for g in graphs])
    rng = np.random.RandomState(0)
    h = rng.randn(128, 16).astype(np.float32)
    gh, gx = rng.randn(128, 16).astype(np.float32), rng.randn(128, 3).astype(
        np.float32)
    src, dst = d['edge_index']
    layer = EGNNLayer(16, 16, edge_features=5,
                      generator=torch.Generator().manual_seed(0))
    layers = {'cpu': layer, 'cuda': EGNNLayer(16, 16, edge_features=5)}
    layers['cuda'].load_state_dict(layer.state_dict())
    layers['cuda'] = layers['cuda'].to(cuda)

    def run(dev):
        def t(a, grad=False):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev).requires_grad_(grad)
        lay = layers['cpu' if dev == 'cpu' else 'cuda']
        lay.zero_grad()
        th, tx, te = t(h, True), t(d['node_pos_features'], True), t(ef, True)
        out_h, out_x = lay(th, tx, t(src).long(), t(dst).long(),
                           t(d['edge_mask']), CooCsr(*(
                               t(a) for a in coo_csr(src, dst, 128))), ef=te)
        ((out_h * t(gh)).sum() + (out_x * t(gx)).sum()).backward()
        return {'h': out_h, 'x': out_x, 'gh': th.grad, 'gx': tx.grad,
                'gef': te.grad, **{n: p.grad for n, p in
                                   lay.named_parameters()}}
    before = (fused_gather_segment_sum.launches,
              fused_gather_segment_sum.backward_launches)
    got = {k: v.detach().cpu() for k, v in run(cuda).items()}
    torch.cuda.synchronize()
    assert (fused_gather_segment_sum.launches - before[0],
            fused_gather_segment_sum.backward_launches - before[1]) == (3, 4)
    again = {k: v.detach().cpu() for k, v in run(cuda).items()}
    ref = run('cpu')
    for k, r in ref.items():
        r = r.detach()
        np.testing.assert_allclose(
            got[k].numpy(), r.numpy(), err_msg=k,
            atol=1e-5 * max(1.0, float(r.abs().max())))
        assert torch.equal(got[k].view(torch.int32),
                           again[k].view(torch.int32)), k
