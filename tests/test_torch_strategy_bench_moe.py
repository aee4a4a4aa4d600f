"""``utils/strategy_bench.py``'s MoE rows on the CPU: ep 4, dp 2 x ep 2,
and sp 4 with ring and with Ulysses attention take their path on a gloo
world of 4 spawned ranks, in fp32 (``--dtype float32``), where the
sharded steps differ from the unsharded one only in the order of sums."""


def test_moe_strategy_rows_run_on_gloo(capsys):
    """Each row's losses stay within 1e-4 of the unsharded run's (the
    bench's own bound is 1e-3) and fall, with the unsharded run's expert
    choices replayed on every rank's rows; Ulysses splits the 4 heads."""
    import json

    from ray_memory_management_tpu_torch.utils import strategy_bench

    rc = strategy_bench.main(["--device", "cpu", "--preset", "test-moe",
                              "--batch", "8", "--seq", "64", "--steps", "2",
                              "--dtype", "float32", "--timeout", "120"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary["failed"]
    assert summary["backend"] == "gloo"
    rows = summary["strategies"]
    assert set(rows) == {"ep", "dp+ep", "sp-ring", "sp-ulysses"}
    assert rows["dp+ep"]["axes"] == {"dp": 2, "ep": 2}
    assert rows["sp-ulysses"]["local_heads"] == 1
    for s, row in rows.items():
        assert row["max_rel_to_reference"] < 1e-4
        assert row["losses"][-1] < row["losses"][0]
        # 2 steps x 2 layers x top-2 rounds of [G, g] choices replayed,
        # half the groups on a dp rank
        moved, choices = row["routing_replayed"]
        assert choices == 2 * 2 * 2 * 8 * 64 // (2 if s == "dp+ep" else 1)
        assert 0 <= moved <= choices
