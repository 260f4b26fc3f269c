"""SLAM layers of the port: losses, map init, densify, tracking and mapping."""
