"""``utils/strategy_bench.py``'s pipeline rows on the CPU: ``pp`` (every
rank a stage) and ``dp+pp`` (dp 2 x pp 2) take their path on a gloo world
of spawned ranks, in fp32 (``--dtype float32``), where the pipelined steps
differ from the unsharded one only in the order of sums. The ``test``
preset's 2 layers make pp 2 on 2 ranks and dp 2 x pp 2 on 4."""

import pytest

from ray_memory_management_tpu_torch.utils import strategy_bench
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("ranks,row,axes", [
    (2, "pp", {"pp": 2}), (4, "dp+pp", {"dp": 2, "pp": 2})])
def test_pipeline_rows_run_on_gloo(capsys, ranks, row, axes):
    """The row's losses stay within 1e-5 of the unsharded run's (the
    bench's own bound is 1e-3) and fall, with as many microbatches as
    stages; each rank's kernels would launch once per layer of its stage
    and microbatch."""
    import json

    rc = strategy_bench.main(["--device", "cpu", "--preset", "test",
                              "--batch", "8", "--seq", "32", "--steps", "2",
                              "--dtype", "float32", "--ranks", str(ranks),
                              "--strategies", row, "--timeout", "120"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary["failed"]
    got = summary["strategies"]
    assert set(got) == {row}
    assert got[row]["axes"] == axes
    assert got[row]["microbatches"] == axes["pp"]
    assert got[row]["max_rel_to_reference"] < 1e-5
    assert got[row]["losses"][-1] < got[row]["losses"][0]
    # (L / S) x M x steps, the unsharded count when M = S
    assert strategy_bench.launches_wanted(row, 0, 2, 2, ranks) == 2 * 2


def test_pipeline_rows_are_for_dense_presets():
    with pytest.raises(SystemExit, match="runs ep,dp\\+ep"):
        strategy_bench.main(["--device", "cpu", "--preset", "test-moe",
                             "--strategies", "pp"])
