"""Array-native DAG generation for the port (numpy + torch)."""
