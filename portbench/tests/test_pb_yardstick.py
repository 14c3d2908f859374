"""The frozen bound rules give chip_smoke.py's figures: the byte bounds
of PERF.md's kernel table on its shapes (8 of the 128 rows, so 8/128 of
each figure), and tests/torch_edges.py's matcher operation counts on
seeded tables."""

import pytest
import torch

from portbench import yardstick

B, N = 8, 1 << 16


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


#: (wrapper, arguments, outputs, PERF.md section 6's bound in ms at 128
#: rows).
CASES = [
    ("window_keys", lambda: (torch.zeros(B, N, dtype=torch.uint8),
                             _i32(B)),
     lambda: torch.zeros(B, N, dtype=torch.int64), 0.02254),
    ("resolve_tiled", lambda: (_i32(B, N), _i32(B, N),
                               torch.zeros(B, dtype=torch.bool)),
     lambda: _i32(B, N), 0.03005),
    ("local_round", lambda: (_i32(B, N),), lambda: _i32(B, N), 0.02003),
    ("cumsum_block", lambda: (_i32(B, N),), lambda: _i32(B, N), 0.02003),
    ("matcher_block_packed", lambda: (_i32(B, N), _i32(B, 7, N), _i32(B),
                                      14, 2, "exact"),
     lambda: (_i32(B, N), _i32(B, N)), 0.1002),
]


@pytest.mark.parametrize("name,args,outs,figure_ms", CASES,
                         ids=[c[0] for c in CASES])
def test_byte_bounds_match_the_table(name, args, outs, figure_ms):
    seconds, by = yardstick.bound(name, args(), outs())
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(figure_ms * B / 128, rel=2e-3)


def test_distinct_counts_a_shared_tensor_once():
    src = _i32(B, N)
    once, _ = yardstick.bound("gather_block", (src, src), _i32(B, N))
    assert once * yardstick.HBM_BYTES_PER_S == pytest.approx(2 * B * N * 4)


@pytest.mark.parametrize("k,sticky,ops", [(14, "exact", 7197434),
                                          (3, "sig", 5713208),
                                          (8, "exact", 6195492)])
def test_matcher_ops_match_torch_edges(k, sticky, ops):
    g = torch.Generator().manual_seed(7)
    t = torch.randint(0, 6, (1, N, k), generator=g)
    t = torch.where(torch.rand((1, N, k), generator=g) < 0.5, t, 0).to(
        torch.int32)
    assert yardstick.matcher_ops(t, sticky) == ops


def test_operation_bound_wins_where_it_is_larger():
    g = torch.Generator().manual_seed(7)
    t = torch.randint(0, 6, (1, N, 3), generator=g).to(torch.int32)
    pref, words = t[..., 0].contiguous(), (t[..., 1] | t[..., 2] << 16)
    seconds, by = yardstick.bound(
        "matcher_block_packed", (pref, words[:, None].contiguous(),
                                 _i32(1), 3, 2, "sig"),
        (_i32(1, N), _i32(1, N)))
    assert by == "operations"
    assert seconds == pytest.approx(
        yardstick.matcher_ops(t, "sig") / yardstick.INT_OPS_PER_S)
