"""Data-parallel training of the port: process groups, rank devices, batch
shards and the process launcher (``dist``), and the DDP step's check
against one process (``parity``)."""
