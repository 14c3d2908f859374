"""Framework-free helpers of the port: corpus access and synthesis, the
results-CSV schema, and the codec's spans, timings and traces on the
card."""
