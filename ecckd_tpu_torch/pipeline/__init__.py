"""The workflow layer of the port: its own copy of ``ecckd_tpu/pipeline``
(the orchestrator and its presets)."""
