"""The port's tree helpers release what they walk: ``tree_map`` must not
keep its input leaves alive past the call (a self-referencing closure in
the walk was a reference cycle that held every leaf until the cyclic
garbage collector ran — the full-width weights of a serving session among
them, which the session's measured peak bytes then counted)."""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tu  # noqa: E402


def test_tree_map_frees_its_leaves_without_the_cycle_collector():
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        x = torch.zeros(3)
        ref = weakref.ref(x)
        out = tu.tree_map(lambda a: a + 1, {"a": x, "b": [x, (x,)]})
        del x
        assert ref() is None
        assert tu.leaves(out)[0].tolist() == [1.0, 1.0, 1.0]
    finally:
        if was_enabled:
            gc.enable()


def test_flatten_unflatten_round_trip_in_sorted_key_order():
    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5}}
    leaves, td = tu.flatten(tree)
    assert leaves == [5, 4, 1, 2, 3]
    assert tu.unflatten(td, leaves) == tree
    with pytest.raises(ValueError):
        tu.unflatten(td, leaves + [6])
