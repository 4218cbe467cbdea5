"""Member-side serving: the predict worker and its engine backend."""
