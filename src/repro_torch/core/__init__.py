"""The batched runahead solve engine and its LM applications."""
