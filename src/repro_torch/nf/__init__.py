"""Shallow network functions (paper §6.1): header-only packet processing.
Firewall, NAT, the Maglev load balancer and the MAC swapper, composed by
``chain.Chain``."""
