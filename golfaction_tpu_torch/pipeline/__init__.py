"""Host pipeline: video I/O and the orchestrator."""
