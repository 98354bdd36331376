"""`python -m repro_torch.launch.monitor <run.jsonl> [--follow]` — the
live run dashboard. Thin alias for repro_torch.obs.monitor so the launch
package stays the single CLI front door."""
from repro_torch.obs.monitor import main

if __name__ == "__main__":
    main()
