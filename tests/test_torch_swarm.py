"""The virtual-node swarm against the port's control daemon: the swarm
case of tests/test_control_stats.py (``test_swarm_fifty_nodes_quick``)
against ``ray_tpu_torch._private.swarm`` — fifty in-process raylets
heartbeat, take and return leases and receive pubsub fan-out, and the
control plane's flight recorder counts it."""

from ray_tpu_torch._private.swarm import run_swarm_bench


def test_swarm_fifty_nodes_quick():
    row = run_swarm_bench(50, hb_interval_s=0.25, settle_s=0.4,
                          lease_secs=1.5, pub_msgs=5)
    assert row["n_nodes"] == 50
    assert row["heartbeat_count"] >= 50
    assert row["heartbeat_errors"] == 0
    assert row["heartbeat_ms_p99"] > 0
    assert row["lease_grants"] > 0
    assert row["pubsub_delivered"] == row["pubsub_expected"] == 250
    assert row["handler_p99_ms"].get("heartbeat", 0) > 0
