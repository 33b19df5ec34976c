"""Runtime supervision of training: heartbeats, stragglers, restarts."""
