"""Datasets of the port: the procedural synthetic scene."""
