"""Pytest settings of the benchmark's own tests (``flowbench/tests``):
the marker of the tests that need a CUDA card. Such a test decides in
its body whether a card is there and skips with the reason when not."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; decides inside the test and skips without one")
