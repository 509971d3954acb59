"""The port's tools: each an array-level core and a file tool."""
