"""Distributed-runtime helpers: the party handoff plan of the supervised
socket cluster (`distributed.elastic`)."""
