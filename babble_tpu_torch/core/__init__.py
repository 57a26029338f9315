"""Host-side DAG model: events (``event``) and the slot index the engine
keeps beside the device state (``dag``)."""
