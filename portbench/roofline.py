"""The bytes and 32-bit operations that the dataplane's stages need for the
packets a run handed them, and the least time the card could take for them.

A bound is ``max(bytes / 3.35 TB/s, ops / 67 T/s)``: one NVIDIA H100 SXM's
HBM bandwidth and float32 (outside the tensor cores) rate by its data
sheet, at the full 700 W power limit; the harness prints the card's power
limit beside every run.

The counts come from a run's counters and link telemetry alone, never from
a table's size, so they read the same work whatever implements it (an
in-place table needs no copy of it).  Each header field a stage reads is
counted once at its wire width, each field it writes once, one table row
read and written per packet that touches one, and the parked payload bytes
written into the table (Split) or restored into the packet (Merge).

The payload bytes follow from the link telemetry, which counts every live
packet's wire bytes (42 B header, the 7 B PayloadPark header once Split
has added it, the payload) where it passes:

  * parked (Split's first passes, a recirculation's retries and
    continuations together) = wire bytes + 7 B a wire packet - bytes sent
    to the server: what the switch keeps of what came in;
  * restored (Merge) = merged bytes - bytes back from the server + 7 B a
    merged packet + the bytes of the packets Merge drops.  Those dropped
    are counted at 49 B each (their payload is not in the telemetry), so
    the count is exact where Merge drops nothing and the least the
    packets need otherwise;
  * NAT reads one slot (7 B: key address, key port, expiry) and refreshes
    one expiry byte per packet that leaves it mapped;
  * the firewall and the LB read their packets' fields once and their
    rules or Maglev entry once per packet.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
OPS32_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
HDR_BYTES = 42               # Ethernet + IPv4 + UDP
CRC_OPS = 32 * 5             # CRC-16 over a 4-byte tag, bit by bit
META_BYTES = 5               # expiry (1), generation (2), length (2)
PP_HDR = 7                   # ENB/OP (1), TI (2), CLK (2), CRC (2)


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS32_PER_S)


def parked_bytes(t: dict) -> int:
    """Payload bytes written into the table over the counted runs."""
    return t["wire_bytes"] + PP_HDR * t["wire_pkts"] - t["to_server_bytes"]


def restored_bytes(t: dict) -> int:
    """Payload bytes Merge gave back to the packets it forwarded (exact
    where Merge drops nothing, else the least)."""
    dropped = t["from_server_pkts"] - t["merged_pkts"]
    return (t["merged_bytes"] - t["from_server_bytes"]
            + PP_HDR * t["merged_pkts"] + (HDR_BYTES + PP_HDR) * dropped)


def split_need(c: dict, t: dict) -> tuple[int, int]:
    """Split (``split_control`` and ``payload_store``), over every Split call
    of the counted runs, recirculation retries and continuations included.
    ``c`` holds the summed counters, ``t`` the summed link telemetry."""
    live = c["splits"] + c["skip_occupied"] + c["skip_small_payload"]
    eligible = c["splits"] + c["skip_occupied"]
    nbytes = (live * (1 + 2)           # alive, payload length
              + live * (PP_HDR + 2)    # the PP header, park length
              + eligible * 2 * META_BYTES
              + 2 * parked_bytes(t))   # read from the packet, stored
    return nbytes, c["splits"] * CRC_OPS


def merge_need(c: dict, t: dict) -> tuple[int, int]:
    """Merge (``merge_stage``): the returning packets' PP headers, the rows
    their tags name, and the payload restored into each merged packet."""
    back = t["from_server_pkts"]
    tagged = c["merges"] + c["explicit_drops"] + c["premature_evictions"] \
        + c["crc_failures"]
    rows = c["merges"] + c["explicit_drops"] + c["premature_evictions"]
    nbytes = (back * (1 + PP_HDR)      # alive, the PP header
              + back * (1 + 2)         # verdict, new length
              + rows * 2 * META_BYTES
              + 2 * restored_bytes(t))  # read from the table, handed out
    return nbytes, tagged * CRC_OPS


def nf_chain_need(t: dict, chain: list, fw_rules: int) -> tuple[int, int]:
    """The NF chain (``nf_chain``): every packet sent to the server passes
    the firewall; the chain's survivors (the packets that come back) pass
    NAT and the LB."""
    sent, kept = t["to_server_pkts"], t["from_server_pkts"]
    nbytes = ops = 0
    if "fw" in chain:
        nbytes += sent * (1 + 4)       # alive, source address
        ops += sent * fw_rules
    if "nat" in chain:
        nbytes += kept * (6 + 7 + 1 + 6)  # key, slot, expiry, rewrite
        ops += kept * 8
    if "lb" in chain:
        nbytes += kept * (13 + 1 + 4)  # 5-tuple, Maglev entry, new dst
        ops += kept * 10
    return nbytes, ops
