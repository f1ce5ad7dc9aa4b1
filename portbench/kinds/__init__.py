"""Drivers of each kind of traffic, found by the mix's ``kind``."""
