"""Roofline of the port: H100 terms over what a traced step counts."""
