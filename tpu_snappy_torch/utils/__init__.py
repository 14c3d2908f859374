"""Framework-free helpers of the port: corpus access and synthesis, the
results-CSV schema, and timers and traces on the card."""
