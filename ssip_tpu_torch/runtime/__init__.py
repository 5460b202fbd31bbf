"""Runtime: device selection and the dtype policy."""
