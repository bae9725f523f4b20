"""Experiment runner and CLI for the Alibaba trace workload."""
