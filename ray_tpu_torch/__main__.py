from ray_tpu_torch.scripts import main

main()
