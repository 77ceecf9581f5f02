"""The frozen generator gives the port's arrays bit for bit; draws are a
function of the seed's words alone; a configuration departs from its source
only where it says so."""

import numpy as np
import pytest

from ccbench.harness import cluster


@pytest.mark.parametrize("props", [
    dict(num_brokers=24, num_racks=4, num_topics=50, num_replicas=3000, mean_cpu=0.006,
         mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=3140),
    dict(num_brokers=40, num_racks=8, num_topics=30, num_replicas=2000, mean_cpu=0.0035,
         mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=3141),
    dict(num_brokers=12, num_racks=3, num_topics=10, num_replicas=500, min_replication=2,
         max_replication=4, distribution="exponential", seed=5),
])
def test_generator_matches_the_port_bit_for_bit(props):
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.testing.random_cluster import (
        ClusterProperties, Distribution, generate)

    port_props = dict(props)
    if "distribution" in port_props:
        port_props["distribution"] = Distribution(port_props["distribution"])
    state, placement, meta = generate(ClusterProperties(**port_props), device="cpu")
    want = state_to_numpy(state, placement)
    snap = cluster.generate(props)
    assert sorted(want) == sorted(snap.packed)
    for key, arr in want.items():
        assert arr.dtype == snap.packed[key].dtype, key
        assert np.array_equal(arr, snap.packed[key]), key
    assert meta.partitions == snap.partitions
    assert meta.topics == snap.topics and meta.racks == snap.racks and meta.hosts == snap.hosts
    assert meta.broker_ids == snap.broker_ids


def test_unknown_property_is_refused():
    with pytest.raises(ValueError):
        cluster.generate(dict(num_brokers=4, num_disks=2))


def test_seed_words_take_any_whole_number():
    big = 2 ** 31 + 12345
    draw = lambda *w: np.random.default_rng(cluster.seed_words(*w)).integers(0, 1 << 30, 8)
    assert np.array_equal(draw(big, 3), draw(big, 3))
    assert not np.array_equal(draw(big, 3), draw(big, 4))
    assert not np.array_equal(draw(big, 3), draw(big + 1, 3))
    assert all(0 <= w < 2 ** 64 for w in cluster.seed_words(-1, 2 ** 70, big))


def test_configurations_depart_from_their_source_only_where_reduced():
    """Every configuration's generator properties are TestConstants'
    BASE_PROPERTIES (the generator's defaults) but for the keys its
    ``BENCHMARK.json`` entry lists in ``reduced``."""
    import json
    from ccbench.tests import helpers
    for entry in helpers.benchmark()["configs"]:
        cfg = json.loads((helpers.REPO / entry["file"]).read_text())
        props = cluster.properties(cfg["cluster"])
        differ = sorted(k for k, v in props.items() if v != cluster.PROPERTIES[k])
        assert differ == sorted(entry["reduced"]) == sorted(cfg["reduced"]), entry["name"]
