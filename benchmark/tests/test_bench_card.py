"""On the card (skips here): a tiny cell runs correct through the
kernels, and its bfloat16 control does not."""

import pytest

from benchmark import harness
from benchmark.tests.helpers import SEED, tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sift1m.grouped.b131072",
                                  "bigann10m.perpair.b65536"])
def test_tiny_cell_on_the_card(card, name):
    cell = tiny(name)
    out = harness.run(name, SEED, 0.5, False, device=card, cell=cell)
    assert out["correct"], out["checks"]
    pack = {**cell.config["index"]["pack"], "dtype": "bfloat16"}
    ctl = harness.run(name, SEED, 0.5, False, device=card, cell=cell,
                      pack=pack)
    assert not ctl["correct"]
