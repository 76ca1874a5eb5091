"""Distributed-runtime helpers: the party handoff plan of the supervised
socket cluster (`distributed.elastic`) and the lossless wire frame
deflation of the chaos link layer (`distributed.compression`)."""
