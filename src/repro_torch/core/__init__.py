"""Core FLOA library of the port: channel, power control, attacks,
standardization, scenario coefficients and the flat OTA aggregation."""
