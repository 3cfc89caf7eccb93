"""Host-side helpers: device selection and stage timers."""
