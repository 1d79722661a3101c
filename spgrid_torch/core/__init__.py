"""Core utilities of the port: config, error metrics, roofline, timing."""
