"""Host-driven execution planes: the checkpoint/resume layer and the
streamed out-of-core fixpoints."""
