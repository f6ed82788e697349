"""python -m craytpu_torch [flags] [scene.json] — the CLI (main.py)."""

from craytpu_torch.main import main

if __name__ == "__main__":
    raise SystemExit(main())
