"""Model code of the port: parameters, layers and the serving steps."""
