"""Calibrated link models (paper §4.1 + the reference's interconnect tiers).

The paper connects its two machines with (i) Gigabit Ethernet and (ii)
802.11 Wi-Fi, noting Wi-Fi "typically introduce[s] latency ranging from
10-60 ms" and substantially lower bandwidth. The ICI and DCN entries are
the reference's (``repro/net/links.py``) modelled interconnect links, kept
with its values because plans are held equal to the reference's: they are
inputs of the cost model, not measurements of any card. The 5G/DCN pair
forms the legs of the device->edge->cloud chain topology
(sim.hardware.three_tier_environment).
"""

from __future__ import annotations

from repro_torch.core.topology import Link

# Effective application-level throughput of GbE is ~117 MB/s (TCP).
GIGABIT_ETHERNET = Link(
    name="gigabit_ethernet", bandwidth=117e6, latency=0.3e-3, jitter=0.05e-3
)

# 802.11n in an interference-prone office: ~6 MB/s effective, 10-60 ms
# latency. We model latency 20 ms +/- 12 ms — the paper's stated range.
WIFI = Link(name="wifi_802.11", bandwidth=6e6, latency=20e-3, jitter=12e-3)

# The reference's modelled inter-chip link (50 GB/s, 1 us): a cost-model input.
ICI = Link(name="tpu_ici", bandwidth=50e9, latency=1e-6, jitter=0.0)

# Cross-pod data-center network: ~25 GB/s effective, ~10 us.
DCN = Link(name="dcn", bandwidth=25e9, latency=10e-6, jitter=2e-6)

# 5G edge (the paper's motivating future deployment): ~60 MB/s, 8 ms.
FIVE_G_EDGE = Link(name="5g_edge", bandwidth=60e6, latency=8e-3, jitter=3e-3)

ALL_LINKS = {
    link.name: link
    for link in (GIGABIT_ETHERNET, WIFI, ICI, DCN, FIVE_G_EDGE)
}
