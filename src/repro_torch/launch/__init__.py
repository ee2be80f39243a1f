"""Launchers: the serving CLI, the paper-table launcher, step and kernel
timing."""
