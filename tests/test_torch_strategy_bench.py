"""``utils/strategy_bench.py`` on the CPU: the four-card run of every
parallel strategy takes its path on a gloo world of 4 spawned ranks."""

from _port_fixtures import one_intra_op_thread  # noqa: F401


def test_strategy_bench_runs_on_gloo(capsys):
    """Each strategy's losses stay within the JAX package's 5e-2 of the
    unsharded run's and fall."""
    import json

    from ray_memory_management_tpu_torch.utils import strategy_bench

    rc = strategy_bench.main(["--device", "cpu", "--preset", "test",
                              "--batch", "8", "--seq", "32", "--steps", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary["failed"]
    assert summary["backend"] == "gloo"
    assert set(summary["strategies"]) == {"dp", "fsdp", "tp", "fsdp+tp"}
    for row in summary["strategies"].values():
        assert row["max_rel_to_reference"] < 5e-2
        assert row["losses"][-1] < row["losses"][0]
