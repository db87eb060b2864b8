"""The harness: cells found by name, runs on one or more ranks, the
window, the traced run, the comparison that decides ``correct``."""
