"""The trace's pure parts: kernel families, busy time and the idle gaps
charged to the innermost host range."""
import pytest

from port_bench import trace


@pytest.mark.parametrize("name,fam", [
    ("void split_decode_tc<PagedRows, 128, 1>(PagedRows, Args)",
     "paged_decode_attention"),
    ("void split_decode_tc<ContigRows, 64, 2>(ContigRows, Args)",
     "decode_attention (split)"),
    ("_Z15split_decode_tcI9PagedRowsLi128ELi1EEvT_4Args",
     "paged_decode_attention"),
    ("void flash_tc<128, 2>(...)", "flash_attention (tensor_core)"),
    ("nvjet_tst_128x256_64x4", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>",
     trace.OTHER),
])
def test_family(name, fam):
    assert trace.family(name) == fam


def test_busy_and_idle_by_innermost_range():
    ms = 1_000_000
    device = [(0, 2 * ms), (1 * ms, 3 * ms), (5 * ms, 6 * ms),
              (10 * ms, 11 * ms)]
    spans = [("engine.step", 0, 8 * ms), ("engine.decode", 2 * ms, 4 * ms),
             ("bench.wait", 9 * ms, 10 * ms)]
    busy, idle = trace._busy_and_idle(device, spans)
    assert busy == pytest.approx(0.005)
    # 3-5 ms starts inside engine.decode; 6-10 ms inside engine.step
    assert idle == pytest.approx({"engine.decode": 0.002,
                                  "engine.step": 0.004})
