"""The port's serving fronts on the conformance draws of zoo width V=1
(``torch_fronts_lane.py`` says what is held to what)."""
from torch_fronts_lane import run_lane


def test_fronts_on_the_conformance_draws():
    run_lane(1)
