"""Runners: one file each, found by the name a configuration file gives."""
