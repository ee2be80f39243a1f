"""Launchers: the serving CLI and step timing."""
