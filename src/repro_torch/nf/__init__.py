"""Shallow network functions (paper §6.1): header-only packet processing.
This slice ports the Firewall -> NAT chain; Maglev LB and MacSwap follow
with the FW -> NAT -> LB slice."""
