"""The kernels' work counts (`repro_torch.kernels.work` and each entry's
`*_work` function) at the shapes of `chip_smoke.py` phase 2: the bound each
gives equals, row for row, the bound PERF.md section 6 records for that
kernel and shape (in microseconds, to its three decimals), with its
limiting term."""

import pytest

from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.work import PEAKS, Work, bound_ms

B, O = "bytes", "operations"

# (row of PERF.md section 6, its work, the bound it records in us, limited by)
ROWS = [
    ("quantize (1024, 2560)", bq.quantize_work(1024, 2560, 2), 2.349, B),
    ("dequantize (1024, 2560)", bq.dequantize_work(1024, 2560, 2), 2.349, B),
    ("rmsnorm serve (1024, 2560)", rn.rmsnorm_work(1024, 2560, 2), 3.132, B),
    ("rmsnorm llava prefill (6016, 7168)", rn.rmsnorm_work(6016, 7168, 2), 51.494, B),
    ("rmsnorm llava decode (2, 7168)", rn.rmsnorm_work(2, 7168, 2), 0.021, B),
    ("rmsnorm seamless encoder (4096, 1024)", rn.rmsnorm_work(4096, 1024, 2), 5.009, B),
    ("rmsnorm seamless decode (4, 1024)", rn.rmsnorm_work(4, 1024, 2), 0.006, B),
    ("rmsnorm llama4 prefill (1024, 5120)", rn.rmsnorm_work(1024, 5120, 2), 6.263, B),
    ("rmsnorm llama4 decode (2, 5120)", rn.rmsnorm_work(2, 5120, 2), 0.015, B),
    ("rmsnorm qwen2 train (4096, 1536)", rn.rmsnorm_work(4096, 1536, 2), 7.513, B),
    ("rmsnorm train_small (512, 512)", rn.rmsnorm_work(512, 512, 2), 0.313, B),
    ("rmsnorm deepseek (1024, 7168)", rn.rmsnorm_work(1024, 7168, 2), 8.768, B),
    ("rmsnorm deepseek q_a (1024, 1536)", rn.rmsnorm_work(1024, 1536, 2), 1.879, B),
    ("rmsnorm deepseek kv_a (1024, 512)", rn.rmsnorm_work(1024, 512, 2), 0.626, B),
    ("rmsnorm deepseek decode (2, 7168)", rn.rmsnorm_work(2, 7168, 2), 0.021, B),
    ("rmsnorm deepseek decode (2, 1536)", rn.rmsnorm_work(2, 1536, 2), 0.005, B),
    ("rmsnorm deepseek decode (2, 512)", rn.rmsnorm_work(2, 512, 2), 0.002, B),
    ("flash serve (8, 128, 32, 80)", fa.flash_work(8, 32, 32, 128, 128, 80, 80, True, 2),
     6.260, B),
    ("flash zamba2 prefill (4, 512, 32, 80)",
     fa.flash_work(4, 32, 32, 512, 512, 80, 80, True, 2), 12.520, B),
    ("flash llava prefill (2, 3008, 56/8, 128)",
     fa.flash_work(2, 56, 8, 3008, 3008, 128, 128, True, 2), 262.399, O),
    ("flash llama4 prefill (2, 512, 40/8, 128)",
     fa.flash_work(2, 40, 8, 512, 512, 128, 128, True, 2), 7.512, B),
    ("flash MLA prefill (2, 512, 128/128, 192), v 128",
     fa.flash_work(2, 128, 128, 512, 512, 192, 128, True, 2), 50.081, B),
    ("flash seamless encoder (4, 1024, 16, 64)",
     fa.flash_work(4, 16, 16, 1024, 1024, 64, 64, False, 2), 17.371, O),
    ("flash seamless cross q 33 over 1024",
     fa.flash_work(4, 16, 16, 33, 1024, 64, 64, False, 2), 5.170, B),
    ("flash causal Sq < Sk", fa.flash_work(2, 16, 4, 300, 1000, 128, 128, True, 2), 1.834, B),
    ("flash causal Sq > Sk", fa.flash_work(2, 16, 4, 1000, 300, 64, 64, True, 2), 2.629, B),
    ("flash f32 serve", fa.flash_work(8, 32, 32, 128, 128, 80, 80, True, 4), 12.520, B),
    ("flash f32 llava prefill", fa.flash_work(2, 56, 8, 3008, 3008, 128, 128, True, 4),
     3873.318, O),
    ("flash f32 seamless encoder", fa.flash_work(4, 16, 16, 1024, 1024, 64, 64, False, 4),
     256.416, O),
    ("flash f32 seamless cross", fa.flash_work(4, 16, 16, 33, 1024, 64, 64, False, 4),
     10.339, B),
    ("flash f32 llama4 prefill", fa.flash_work(2, 40, 8, 512, 512, 128, 128, True, 4),
     80.286, O),
    ("flash f32 MLA prefill", fa.flash_work(2, 128, 128, 512, 512, 192, 128, True, 4),
     321.146, O),
    ("decode stablelm-3b", da.decode_work(8, 32, 32, 160, 80, 2), 3.937, B),
    ("decode zamba2-2.7b", da.decode_work(4, 32, 32, 528, 80, 2), 6.468, B),
    ("decode llava-next-34b", da.decode_work(2, 56, 8, 3024, 128, 2), 7.412, B),
    ("decode seamless self", da.decode_work(4, 16, 16, 33, 64, 2), 0.166, B),
    ("decode seamless cross", da.decode_work(4, 16, 16, 1024, 64, 2), 5.013, B),
    ("decode llama4", da.decode_work(2, 40, 8, 528, 128, 2), 1.303, B),
    ("decode qwen3-14b", da.decode_work(1, 40, 8, 4096, 128, 2), 5.014, B),
    ("ssd_scan zamba2 prefill", ssd.scan_work(4, 512, 80, 64, 64, 256, 2, True, False),
     14.437, B),
    ("ssd_scan mLSTM bf16", ssd.scan_work(4, 512, 4, 1024, 1025, 256, 2, False, True),
     58.708, O),
    ("ssd_scan mLSTM f32", ssd.scan_work(4, 512, 4, 1024, 1025, 256, 4, False, True),
     182.662, O),
    ("rmsnorm_backward qwen2 train", rn.rmsnorm_backward_work(4096, 1536, 2), 11.270, B),
    ("rmsnorm_backward train_small", rn.rmsnorm_backward_work(512, 512, 2), 0.470, B),
    ("rmsnorm_backward serve shape", rn.rmsnorm_backward_work(1024, 2560, 2), 4.698, B),
    ("forward_lse qwen2 train", fa.forward_lse_work(4, 12, 2, 1024, 1024, 128, 128, True),
     13.041, O),
    ("forward_lse G = 1", fa.forward_lse_work(2, 8, 8, 1024, 1024, 128, 128, True), 5.028, B),
    ("forward_lse seamless encoder",
     fa.forward_lse_work(4, 16, 16, 1024, 1024, 64, 64, False), 17.371, O),
    ("forward_lse seamless cross", fa.forward_lse_work(4, 16, 16, 256, 1024, 64, 64, False),
     6.280, B),
    ("forward_lse MLA train", fa.forward_lse_work(4, 128, 128, 1024, 1024, 192, 128, True),
     200.951, B),
    ("forward_lse G = 16", fa.forward_lse_work(2, 32, 2, 1024, 1024, 128, 128, True),
     17.388, O),
    ("forward_lse D = Dv = 192", fa.forward_lse_work(2, 8, 2, 512, 512, 192, 192, False),
     3.257, O),
    ("backward qwen2 train", fa.backward_work(4, 12, 2, 1024, 1024, 128, 128, True),
     32.602, O),
    ("backward G = 1", fa.backward_work(2, 8, 8, 1024, 1024, 128, 128, True), 10.867, O),
    ("backward train_small", fa.backward_work(4, 8, 2, 128, 128, 64, 64, True), 0.787, B),
    ("backward seamless encoder", fa.backward_work(4, 16, 16, 1024, 1024, 64, 64, False),
     43.427, O),
    ("backward seamless cross", fa.backward_work(4, 16, 16, 256, 1024, 64, 64, False),
     12.540, B),
    ("backward ragged non-causal", fa.backward_work(2, 8, 2, 33, 1000, 64, 64, False),
     0.693, B),
    ("backward causal Sq < Sk", fa.backward_work(2, 16, 4, 300, 1000, 128, 128, True),
     4.535, B),
    ("backward causal Sq > Sk", fa.backward_work(2, 16, 4, 1000, 300, 64, 64, True),
     5.296, B),
    ("backward MLA train", fa.backward_work(4, 128, 128, 1024, 1024, 192, 128, True),
     452.086, O),
    ("backward G = 16", fa.backward_work(2, 32, 2, 1024, 1024, 128, 128, True), 43.470, O),
    ("backward D = Dv = 192", fa.backward_work(2, 8, 2, 512, 512, 192, 192, False), 8.143, O),
    ("ssd_scan_backward zamba2 train",
     ssd.scan_backward_work(4, 1024, 80, 64, 64, 256, True, False, False), 64.001, O),
    ("ssd_scan_backward mLSTM train",
     ssd.scan_backward_work(4, 1024, 4, 1024, 1025, 256, False, True, False), 365.261, O),
    ("ssd_scan_backward ragged, final-state cotangent",
     ssd.scan_backward_work(2, 1000, 80, 64, 64, 256, True, False, True), 30.830, O),
]


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_bound_equals_perf_row(row):
    _, work, us, by = row
    ms, limit = bound_ms(work)
    assert round(ms * 1e3, 3) == pytest.approx(us, abs=1e-9)
    assert limit == by


def test_bound_takes_each_class_at_its_peak():
    """Operations of several classes add, each over its own peak; the
    bytes term stands apart."""
    w = Work(0.0, (("bf16", PEAKS["bf16"]), ("bf16x2", PEAKS["bf16x2"]), ("f32", PEAKS["f32"])))
    assert bound_ms(w) == (pytest.approx(3e3), "operations")
    assert bound_ms(Work(3.35e12)) == (pytest.approx(1e3), "bytes")
