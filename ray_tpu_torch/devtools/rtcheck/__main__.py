from ray_tpu_torch.devtools.rtcheck.core import main

raise SystemExit(main())
