"""Packets, counters, header tags and the Split/Merge state machine."""
