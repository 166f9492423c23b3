"""The control on the card: the reference in TF32, put in the program's
place on the maps a run compares, at each cell's own size, fails the
cell's limit on three seeds. Run where there is a card:

    python -m pytest portbench/tests/test_portbench_control.py -q -s -p no:cacheprovider
"""

import json

import pytest

from portbench import spec as specs
from portbench.control import readings
from portbench.spec import Spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in Spec().bench["workloads"]])
def test_the_control_fails_the_limit(card, cell):
    limit = specs.limits(cell)["limit"]
    for r in readings(Spec(), cell, [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]):
        print(json.dumps(r))
        assert r["control"] > limit, r
