"""Builders of the program's cases, one file per ``case`` of a configuration."""
