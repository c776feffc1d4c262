#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU, at full size, before a chip run.

    python3 scripts/rehearse_chip_smoke.py [--phase 22 | 23 | 24]

A machine without a card cannot build or launch the CUDA kernels, so this
runs every phase of ``chip_smoke.py`` with:

- the device set to the CPU, and ``torch.cuda``'s events, synchronise,
  device name and count replaced by host-clock stand-ins;
- the build skipped and ``nvidia-smi`` answered with a placeholder;
- each kernel wrapper's plain path counted as one launch, so the launch
  checks run as they would on the card;
- every timing taken over 1 call instead of 200, and no device time (nor
  P2-bf16's launch floor or add latency);
- P4 and the encoder cut to a size the CPU can hold (attention [2, 2,
  128, 64], crossover shapes of 2048 tokens up to S = 512, the float32
  forward's at S = 512 only, an encoder of
  hidden 64 and 2 layers trained at lr 1e-2), phase 15's engine to 1024
  molecules (256 to validate every 2 steps), chunks of 1 batch and 3
  dropout masks, GROVER to hidden 32, 2 heads and batch 32 over 96
  molecules and MAT to dim 32, 2 layers and 4 heads over 64, phase 23's
  models to a few filters and GRUs of 8-16 over 48-96 molecules and
  images of 32-75 pixels, and SDPA without a chosen backend;
- the card's memory counters read as 0.

With ``--phase 22`` it runs phase 22 (GROVER and MAT) alone, with
``--phase 23`` phase 23 (the sequence and image models), with ``--phase
24`` phase 24 (the data layer and the MoleculeNet harness, at full size:
about 50 s on 8 CPU cores, the scaffold split of 8014 ids the longest).  It finds
wrong paths, shapes, counts and control flow.  Its times are the
CPU's and mean nothing for the card; its errors are 0 because both sides
of each comparison are the plain version, but for the P2 and P3 cases,
which hold the plain version in float32 against float64: at GROVER's
flat batch the to-bond sums' backward sums every pad slot into row 0, a
segment of thousands of rows, which the float32 plain version adds one
by one and can carry past SUM_RTOL (the card's kernel splits such a
segment and stays within half of it).  Exits with chip_smoke's code.
"""

import importlib
import subprocess
import sys
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


class _HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def main() -> int:
    import torch
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda i=0: 'cpu rehearsal'
    torch.cuda.device_count = lambda: 1
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.Event = _HostEvent
    torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    subprocess.run = lambda *a, **k: types.SimpleNamespace(
        stdout='cpu rehearsal, no power limit\n')

    from deepchem_tpu_torch.kernels import build
    build.build_all = lambda names=None: None
    build.load = lambda name: None
    build.build_log = lambda name: ('not built: cpu rehearsal; 0 bytes '
                                    'spill stores, 0 bytes spill loads')

    from deepchem_tpu_torch.ops import csr_segment
    softmax_fwd = csr_segment._softmax_forward
    sum_fwd = csr_segment._segment_sum_forward
    gather_fwd_p2 = csr_segment._gather_sum_forward

    def counted_softmax(logits, row_ptr):
        csr_segment.csr_segment_softmax.launches += 1
        return softmax_fwd(logits, row_ptr)

    def counted_sum(msgs, row_ptr):
        csr_segment.csr_segment_sum.launches += 1
        return sum_fwd(msgs, row_ptr)

    def counted_p2(h, src, row_ptr, attr='launches'):
        if h.dtype == torch.bfloat16:
            attr = 'bf16_launches'
        p2 = csr_segment.fused_gather_segment_sum
        setattr(p2, attr, getattr(p2, attr) + 1)
        return gather_fwd_p2(h, src, row_ptr, attr)
    flash = importlib.import_module('deepchem_tpu_torch.ops.flash_attention')
    flash_fwd = flash.flash_attention_forward
    flash_dkv, flash_dq = flash.flash_attention_bwd_dkv, \
        flash.flash_attention_bwd_dq

    def counted_flash_fwd(*args):
        flash.flash_attention.launches += 1
        return flash_fwd(*args)

    def counted_flash_dkv(*args):
        flash_dkv.launches += 1
        return flash_dkv(*args)

    def counted_flash_dq(*args):
        flash_dq.launches += 1
        return flash_dq(*args)

    nei = importlib.import_module('deepchem_tpu_torch.ops.nei_table')
    seg = importlib.import_module('deepchem_tpu_torch.ops.segment')
    nei_sum_fwd, nei_max_fwd, nei_max_bwd = (
        nei._nei_sum_forward, nei._nei_max_forward, nei._nei_max_backward)
    pool_fwd, pool_bwd = seg._graph_max_forward, seg._graph_max_backward

    # the float4 launches that nei_table.cu's and graph_pool.cu's entries
    # would count: F a multiple of 4 and 16-byte-aligned rows (outputs are
    # fresh, so aligned); K1, K2's backward, K2's forward, K3's forward,
    # K3's backward (K4's, in nei_gather.cu, below)
    float4 = [0, 0, 0, 0, 0]

    def vec4(*tensors):
        return tensors[0].shape[1] % 4 == 0 \
            and all(t.data_ptr() % 16 == 0 for t in tensors)

    def counted_nei_sum(h, table, deg, counter, attr='launches'):
        float4[0] += vec4(h)
        setattr(counter, attr, getattr(counter, attr) + 1)
        return nei_sum_fwd(h, table, deg, counter, attr)

    def counted_nei_max_fwd(h, table, deg):
        float4[2] += vec4(h)
        nei.nei_max_incl_self.launches += 1
        return nei_max_fwd(h, table, deg)

    def counted_nei_max_bwd(g, table, deg, winner):
        float4[1] += vec4(g, winner)
        nei.nei_max_incl_self.backward_launches += 1
        return nei_max_bwd(g, table, deg, winner)

    def counted_pool_fwd(x, row_ptr, mask):
        float4[3] += vec4(x)
        seg.graph_max_pool.launches += 1
        return pool_fwd(x, row_ptr, mask)

    def counted_pool_bwd(g, x, row_ptr, mask, mx, den):
        float4[4] += vec4(g, x, mx, den)
        seg.graph_max_pool.backward_launches += 1
        return pool_bwd(g, x, row_ptr, mask, mx, den)

    gather_fwd = nei._nei_gather_forward
    gather4 = [0]

    def counted_gather_fwd(x, table, deg):
        gather4[0] += vec4(x)
        nei.nei_gather.launches += 1
        return gather_fwd(x, table, deg)

    nei._nei_gather_forward = counted_gather_fwd
    nei.nei_gather_float4_launches = lambda: gather4[0]
    nei._nei_sum_forward = counted_nei_sum
    nei._nei_max_forward = counted_nei_max_fwd
    nei._nei_max_backward = counted_nei_max_bwd
    nei.float4_launches = lambda: tuple(float4[:3])
    seg.graph_max_pool_float4_launches = lambda: tuple(float4[3:])
    seg._graph_max_forward = counted_pool_fwd
    seg._graph_max_backward = counted_pool_bwd
    flash.flash_attention_forward = counted_flash_fwd
    flash.flash_attention_bwd_dkv = counted_flash_dkv
    flash.flash_attention_bwd_dq = counted_flash_dq
    csr_segment._softmax_forward = counted_softmax
    csr_segment._segment_sum_forward = counted_sum
    csr_segment._gather_sum_forward = counted_p2

    source = (REPO / 'chip_smoke.py').read_text().replace(
        "torch.device('cuda', 0)", "torch.device('cpu')")
    smoke = types.ModuleType('chip_smoke')
    smoke.__file__ = str(REPO / 'chip_smoke.py')
    exec(compile(source, smoke.__file__, 'exec'), smoke.__dict__)
    timed = smoke.time_ms
    smoke.time_ms = lambda fn, iters=200, warmup=10: timed(
        fn, iters=1, warmup=min(warmup, 1))
    # no device here: no device times, no launch floor, no add latency
    nan = float('nan')
    smoke.device_us = lambda fn, kernel, bound_us=0.0, calls=20: nan
    smoke.p2_bf16_floor_us = lambda h, row_ptr: {
        'new_grid_us': nan, 'parent_grid_us': nan, 'floor_us': nan}
    smoke.bf16_add_ns = lambda dev: {'pair': nan, 'single': nan}
    smoke.device_us_all = lambda fn, calls=20, top=0: (
        (float('nan'), 0.0) + (([],) if top else ()))
    smoke.library_attention = lambda q, k, v, scale: \
        torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         scale=scale)
    smoke.FLASH_MAIN = (2, 2, 128, 64)
    smoke.CROSSOVER_TOKENS, smoke.CROSSOVER_S = 2048, (128, 256, 512)
    smoke.F32_CROSSOVER_S = (512,)
    smoke.PLAIN_ROWS_FROM_S = 512
    smoke.ENCODER = dict(smoke.ENCODER, hidden=64, layers=2, heads=2,
                         intermediate=128)
    smoke.ENCODER_LR = 1e-2
    smoke.ENGINE_MOLECULES, smoke.ENGINE_VALID = 1024, 256
    smoke.ENGINE_CHUNK, smoke.UNCERTAINTY_MASKS = 1, 3
    smoke.ENGINE_INTERVAL = 2
    smoke.GROVER = dict(smoke.GROVER, hidden_size=32, num_heads=2,
                        batch_size=32)
    smoke.GROVER_MOLECULES = 96
    smoke.MAT = dict(smoke.MAT, dim=32, n_layers=2, n_heads=4)
    smoke.MAT_MOLECULES = 64
    smoke.SEQ_MOLECULES = 240
    smoke.TEXTCNN = dict(smoke.TEXTCNN, n_embedding=8,
                         kernel_sizes=(1, 2, 5), num_filters=(4, 6, 4))
    smoke.SMILES2VEC = dict(smoke.SMILES2VEC, embedding_dim=8, filters=8,
                            rnn_sizes=(8, 16))
    smoke.SMILES2VEC_SEQ = dict(max_len=40, pad_len=2)
    smoke.CHEMCEPTION = dict(smoke.CHEMCEPTION, img_size=32, base_filters=4)
    smoke.AUTOENCODER = dict(max_output_length=20, embedding_dimension=16,
                             encoder_layers=2, decoder_layers=2)
    smoke.CNN_1D = dict(smoke.CNN_1D, layer_filters=(16,), dense_layer_size=64)
    smoke.UNET_SIZE, smoke.INCEPTION_SIZE, smoke.ONEFORMER_SIZE = 32, 75, 64
    smoke.ONEFORMER = dict(smoke.ONEFORMER, image_size=(64, 64), hidden=32,
                           dec_layers=2)
    if sys.argv[1:] == ['--phase', '24']:
        smoke.molnet_phase(torch.device('cpu'), 'cpu rehearsal')
        return 0
    if sys.argv[1:] == ['--phase', '23']:
        smoke.seq_image_phase(torch.device('cpu'), 'cpu rehearsal')
        return 0
    if sys.argv[1:] == ['--phase', '22']:
        smoke.grover_mat_phase(torch.device('cpu'), 'cpu rehearsal')
        return 0
    return smoke.main()


if __name__ == '__main__':
    sys.exit(main())
