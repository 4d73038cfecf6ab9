"""The share of slot-rounds in the window spent on a query that had not yet
converged: the rounds that the window's tickets consumed inside it (each
ticket's ``Ticket.rounds`` less what it had at the window's start) over
the slots times the rounds the server ran in the window
(``ServerStats.rounds_total``'s growth)."""


def read(rec):
    slot_rounds = rec.get("slot_rounds")
    if not slot_rounds:
        return None
    return 100.0 * rec["useful_slot_rounds"] / slot_rounds
