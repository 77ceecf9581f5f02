"""Goals as broadcastable tensor predicates (violation, cost, acceptance)."""
