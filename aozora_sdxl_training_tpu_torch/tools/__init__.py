"""The port's tools: the quantization tools of the QAT repair flow (convert,
profile, export, inspect) and developer probes run on the card."""
