"""Subpackage of omg_tools_torch (see the package docstring)."""
