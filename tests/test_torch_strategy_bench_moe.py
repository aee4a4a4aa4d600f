"""``utils/strategy_bench.py``'s MoE rows on the CPU: ep 4, dp 2 x ep 2,
and sp 4 with ring and with Ulysses attention, then the expert weights
under fsdp 4, tp 4, fsdp 2 x tp 2 and ep 2 x tp 2 and dp 2 x sp 2 with
ring and with Ulysses attention, take their path on a gloo world of 4
spawned ranks, in fp32 (``--dtype float32``), where the sharded steps
differ from the unsharded one only in the order of sums."""

import json

from _port_fixtures import one_intra_op_thread  # noqa: F401

# the rows of the preset's first four, then of the sharded layouts
FIRST = ("ep", "dp+ep", "sp-ring", "sp-ulysses")
SHARDED = ("fsdp", "tp", "fsdp+tp", "ep+tp", "dp+sp-ring", "dp+sp-ulysses")


def _run(capsys, rows, seq):
    from ray_memory_management_tpu_torch.utils import strategy_bench

    rc = strategy_bench.main(["--device", "cpu", "--preset", "test-moe",
                              "--batch", "8", "--seq", str(seq), "--steps",
                              "2", "--dtype", "float32", "--timeout", "120",
                              "--strategies", ",".join(rows)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary["failed"]
    assert summary["backend"] == "gloo"
    assert set(summary["strategies"]) == set(rows)
    return summary["strategies"]


def _held(rows, seq, data_ranks):
    """Each row's losses stay within 1e-4 of the unsharded run's (the
    bench's own bound is 1e-3, or 5e-2 with tp) and fall, with the
    unsharded run's expert choices replayed on every rank's rows: 2 steps
    x 2 layers x top-2 rounds of [G, g] choices, a data rank's share of
    the groups."""
    for s, row in rows.items():
        assert row["max_rel_to_reference"] < 1e-4, s
        assert row["losses"][-1] < row["losses"][0], s
        moved, choices = row["routing_replayed"]
        assert choices == 2 * 2 * 2 * 8 * seq // data_ranks[s], s
        assert 0 <= moved <= choices


def test_moe_strategy_rows_run_on_gloo(capsys):
    """The first four rows; Ulysses splits the 4 heads."""
    rows = _run(capsys, FIRST, 64)
    assert rows["dp+ep"]["axes"] == {"dp": 2, "ep": 2}
    assert rows["sp-ulysses"]["local_heads"] == 1
    _held(rows, 64, {"ep": 1, "dp+ep": 2, "sp-ring": 1, "sp-ulysses": 1})


def test_sharded_moe_strategy_rows_run_on_gloo(capsys):
    """The sharded layouts' rows, at S = 128 so that fsdp 4's two rows a
    rank hold whole dispatch groups of 256 tokens; Ulysses over sp 2
    gives each rank 2 of the 4 heads, tp 2 as much."""
    from ray_memory_management_tpu_torch.utils import strategy_bench

    assert set(FIRST + SHARDED) == set(strategy_bench.MOE_STRATEGIES)
    rows = _run(capsys, SHARDED, 128)
    assert rows["ep+tp"]["axes"] == {"ep": 2, "tp": 2}
    assert rows["dp+sp-ring"]["axes"] == {"dp": 2, "sp": 2}
    assert rows["dp+sp-ulysses"]["local_heads"] == 2
    assert rows["ep+tp"]["local_heads"] == 2
    assert rows["tp"]["local_heads"] == 1
    # the ring's ranks attend 1 and 2 chunks a layer on each data rank
    assert [strategy_bench.launches_wanted("dp+sp-ring", r, 2, 2, 4)
            for r in range(4)] == [4, 8, 4, 8]
    _held(rows, 128, {"fsdp": 4, "tp": 1, "fsdp+tp": 2, "ep+tp": 1,
                      "dp+sp-ring": 2, "dp+sp-ulysses": 2})
