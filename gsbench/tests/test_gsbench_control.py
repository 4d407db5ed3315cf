"""The control and the planted faults come out as not correct, at a size
a test run can hold (the CPU, the plain path); the chip run of
``python3 -m gsbench.control`` reads them at the cells' own sizes."""
import pytest

from gsbench import check, control, run as gsrun


@pytest.mark.parametrize("cell", ["garden1m-refine", "garden6m-refine",
                                  "garden6m-serve", "garden1m-densify"])
def test_control_and_faults_fail_the_limits(cell, tiny, tiny_densify,
                                            densify_spec):
    config, mix = (tiny_densify if cell == "garden1m-densify"
                   else (tiny, None))
    run = gsrun.new_run(cell, 2 ** 31 + 99, "cpu", spec=densify_spec,
                        config_update=config, traffic_update=mix)
    lim = check.limits(cell)
    readings = control.readings_of(run)(run)
    # the densify loop reads the program's own numbers beside them
    readings.pop("program", None)
    assert readings
    for variant, numbers in readings.items():
        failed = [k for k, v in numbers.items() if not v <= lim[k]]
        assert failed, (variant, numbers)
