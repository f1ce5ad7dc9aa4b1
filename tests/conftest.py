import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))   # import _propcheck anywhere


def pytest_addoption(parser):
    parser.addoption(
        "--seed", action="store", type=int, default=None,
        help="Seed for the _propcheck property-test shim (reproduces "
             "generated cases; ignored when real hypothesis is installed).")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
    seed = config.getoption("--seed")
    if seed is not None:
        import _propcheck
        _propcheck.GLOBAL_SEED = seed
