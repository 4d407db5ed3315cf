"""The control and the planted faults come out as not correct, at a size
a test run can hold (the CPU, the plain path); the chip run of
``python3 -m gsbench.control`` reads them at the cells' own sizes."""
import pytest

from gsbench import check, control, run as gsrun


@pytest.mark.parametrize("cell", ["garden1m-refine", "garden6m-refine",
                                  "garden6m-serve"])
def test_control_and_faults_fail_the_limits(cell, tiny):
    run = gsrun.new_run(cell, 2 ** 31 + 99, "cpu", config_update=tiny)
    fn = (control.train_readings if run.traffic["loop"] == "train"
          else control.serve_readings)
    lim = check.limits(cell)
    for variant, numbers in fn(run).items():
        failed = [k for k, v in numbers.items() if not v <= lim[k]]
        assert failed, (variant, numbers)
